"""Model configuration, registry, layers and the dense transformer."""

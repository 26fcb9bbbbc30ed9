"""Certificate vocabulary shared by the port's spec constructor."""

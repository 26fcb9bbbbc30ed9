"""Quantizers, packed serving weights and the linear-layer funnel."""

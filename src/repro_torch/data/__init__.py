"""The synthetic language-model data stream of the training path."""

from .pipeline import DataConfig, SyntheticStream

__all__ = ["DataConfig", "SyntheticStream"]

from .pipeline import SyntheticPipeline

__all__ = ["SyntheticPipeline"]

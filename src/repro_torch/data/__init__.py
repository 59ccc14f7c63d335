"""Deterministic synthetic data (twin of the reference's ``repro.data``)."""
from . import pipeline
from .pipeline import ImagePipeline, TokenPipeline

__all__ = ["pipeline", "ImagePipeline", "TokenPipeline"]

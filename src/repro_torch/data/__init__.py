"""Deterministic synthetic data (twin of the reference's ``repro.data``;
``TokenPipeline`` is not ported yet)."""
from . import pipeline
from .pipeline import ImagePipeline

__all__ = ["pipeline", "ImagePipeline"]

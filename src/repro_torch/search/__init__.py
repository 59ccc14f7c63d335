"""HummingBird's offline phase: the MPC simulator, the search engine
(eco and budgeted) and finetuning (twin of the reference's
``repro.search``)."""
from . import engine, finetune, simulator
from .engine import SearchResult, search_budget, search_eco

__all__ = ["engine", "finetune", "simulator", "SearchResult",
           "search_budget", "search_eco"]

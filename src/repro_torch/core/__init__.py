"""The protocol: ring arithmetic, sharing, triples, comms and the GMW engine."""
from . import (beaver, comm, costmodel, fixed, gmw, hummingbird, prng, ring,
               ring_linalg, schedule, shares)
from .hummingbird import HBConfig, HBLayer
from .mpc_tensor import MPCTensor, encode_weights, relu_many

__all__ = [
    "beaver", "comm", "costmodel", "fixed", "gmw", "hummingbird", "prng",
    "ring", "ring_linalg", "schedule", "shares", "HBConfig", "HBLayer",
    "MPCTensor", "encode_weights", "relu_many",
]

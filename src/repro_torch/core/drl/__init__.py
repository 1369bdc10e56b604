"""The DRL partitioning selector (paper §3.1.3, §4.3): actor-critic
networks, the A3C agent and the trace-driven simulator it trains on; the
port of the JAX package's ``core/drl/``."""

from .agent import A3CAgent, A3CConfig, Transition
from .env import QueryStat, SimConfig, TraceSimulator, tpch_like_library
from .networks import ActorCritic

__all__ = ["A3CAgent", "A3CConfig", "Transition", "QueryStat", "SimConfig",
           "TraceSimulator", "tpch_like_library", "ActorCritic"]

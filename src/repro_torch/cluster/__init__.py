"""Cluster tier (DESIGN §14): partition directory, multi-node store,
incremental elastic rebalancing.

Built on the decomposition SNIPPETS §1 describes and Whiz
(arXiv:1703.10272) motivates — an explicit partition→location service
decoupled from compute:

* :mod:`.directory` — :class:`PartitionDirectory`: partition id → node
  (consistent-hash / range), versioned epochs, replication sets;
* :mod:`.node` — :class:`ClusterDurableStore`: the durable tier sharded
  across directories-as-nodes, replica-fallback reads;
* :mod:`.rebalancer` — :class:`Rebalancer`: minimal-move placement
  changes published through the store's atomic generation flip;
* :mod:`.control` — :class:`ClusterHealth`: heartbeats + straggler
  detection (the formerly-dormant runtime modules) feeding Autopilot
  signals.

Entry point: ``PartitionStore(root=..., cluster=ClusterConfig(...))`` or
``Session(store_path=..., cluster=ClusterConfig(nodes=("a", "b")))``.
"""

from .control import ClusterHealth, ClusterSignal
from .directory import (CONSISTENT_HASH, RANGE_PLACEMENT, STRATEGIES,
                        ClusterConfig, PartitionDirectory)
from .node import ClusterDurableStore, Node
from .rebalancer import (RebalanceAborted, RebalancePlan, RebalanceResult,
                         Rebalancer)

__all__ = ["ClusterConfig", "PartitionDirectory", "ClusterDurableStore",
           "Node", "Rebalancer", "RebalancePlan", "RebalanceResult",
           "RebalanceAborted", "ClusterHealth", "ClusterSignal",
           "CONSISTENT_HASH", "RANGE_PLACEMENT", "STRATEGIES"]

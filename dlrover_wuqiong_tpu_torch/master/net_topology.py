"""Network-topology-aware rank ordering for rendezvous.

Parity: a copy of dlrover_wuqiong_tpu/master/net_topology.py:1-72 (no
JAX), kept in the port because the port imports nothing of the JAX
package: `NodeTopologyMeta`, `DefaultTopologyQuerier` and
`DpTopologySorter`, with the same ordering, so a port master and a JAX
master rank the same nodes the same way.  Nodes of one locality group
(an explicit slice id, e.g. one NVLink domain, else the /24 subnet of the
reported IP) get contiguous ranks.  (The JAX module's own parity:
reference `master/elastic_training/net_topology.py:21-88`.)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from ..common.log import get_logger

logger = get_logger("net_topology")


@dataclasses.dataclass
class NodeTopologyMeta:
    node_id: int
    node_rank: int
    ip: str = ""
    slice_id: str = ""


class DefaultTopologyQuerier:
    """Locality key for a node (parity DefaultTopologyQuerier).

    Priority: explicit slice id > /24 subnet of the reported IP > "".
    """

    def query(self, ip: str, slice_id: str = "") -> str:
        if slice_id:
            return slice_id
        if ip and ip.count(".") == 3:
            return ip.rsplit(".", 1)[0]  # /24 locality proxy
        return ""


class DpTopologySorter:
    """Order nodes so same-locality nodes get contiguous ranks.

    Parity: DpTopologySorter (net_topology.py:56) — stable within a
    locality group by the node's declared rank hint, groups ordered by
    their smallest member so restarts keep the assignment stable.
    """

    def __init__(self, querier: Optional[DefaultTopologyQuerier] = None):
        self.querier = querier or DefaultTopologyQuerier()

    def sort(self, metas: Sequence[NodeTopologyMeta]
             ) -> List[NodeTopologyMeta]:
        groups: Dict[str, List[NodeTopologyMeta]] = {}
        for m in metas:
            key = self.querier.query(m.ip, m.slice_id)
            groups.setdefault(key, []).append(m)
        for g in groups.values():
            g.sort(key=lambda m: (m.node_rank, m.node_id))
        ordered_groups = sorted(
            groups.values(),
            key=lambda g: (g[0].node_rank, g[0].node_id))
        out: List[NodeTopologyMeta] = []
        for g in ordered_groups:
            out.extend(g)
        return out

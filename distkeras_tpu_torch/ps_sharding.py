"""Parameter-server sharding, a copy of the part of
``distkeras_tpu/ps_sharding.py`` that the unsharded host parameter server
needs: :class:`PSShardDown`, the error its training driver re-raises
even when it would tolerate a worker's death.

The shard plan, the sharded client and the shard server group
(``ShardPlan``, ``make_shard_plan``, ``ShardedPSClient``,
``ShardedServerGroup``) wait for ROADMAP queue A item 6; the trainers
refuse ``ps_shards > 1`` and ``recovery=True`` until then.
"""

from __future__ import annotations

from typing import Optional, Tuple


class PSShardDown(ConnectionError):
    """A parameter-server *shard* is unreachable.

    Distinct from a worker death (which the PS engines can tolerate): a
    shard holds a partition of the center weights, so losing one loses part
    of the model — ``run_host_ps_training`` re-raises this even under
    ``fault_tolerance=True`` instead of degrading to survivors.
    """

    def __init__(self, shard_id: int, addr: Optional[Tuple[str, int]] = None,
                 detail: Optional[str] = None):
        self.shard_id = int(shard_id)
        self.addr = addr
        msg = f"PS shard {self.shard_id}"
        if addr is not None:
            msg += f" at {addr[0]}:{addr[1]}"
        msg += " is down"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)

"""The paper's OpenSHMEM runtime on the SIM backend (port of
`repro/core`): topology and alpha-beta model, compiled patterns and
schedules, teams, the symmetric heap, the SIM network, the §3.6
collectives, the ShmemContext API, and the fusion layer (`core.fusion`:
ring attention and the fused reduce-scatter -> AdamW, with their
pricing).  The SPMD backend, the profiler, tracer, tuner, fault injector
and elastic recovery are not ported yet."""
from . import (abmodel, collectives, fault, heap, netops, pattern, shmem,
               team, topology)
from .fault import DeadlineExceeded, LinkFailure, PEFailure
from .netops import NetOps, NocSimNetOps, SimNetOps
from .pattern import CommPattern, Schedule, Stage, as_pattern, compile_pattern
from .shmem import Ctx, RetryPolicy, ShmemContext, sim_ctx, spmd_ctx
from .team import (Team, TeamPartition, from_active_set, make_team, split_2d,
                   split_strided, team_world)
from .topology import MeshTopology, epiphany3, v5e_multipod, v5e_pod

__all__ = [
    "abmodel", "collectives", "fault", "heap", "netops", "pattern", "shmem",
    "team", "topology", "DeadlineExceeded", "LinkFailure", "PEFailure",
    "RetryPolicy", "NetOps", "NocSimNetOps", "SimNetOps", "CommPattern",
    "Schedule", "Stage", "as_pattern", "compile_pattern", "Ctx",
    "ShmemContext", "sim_ctx", "spmd_ctx", "Team", "TeamPartition",
    "from_active_set", "make_team", "split_2d", "split_strided",
    "team_world", "MeshTopology", "epiphany3", "v5e_multipod", "v5e_pod",
]

"""The paper's OpenSHMEM runtime on the SIM backend (port of
`repro/core`): topology and alpha-beta model, compiled patterns and
schedules, teams, the symmetric heap, the SIM network, the §3.6
collectives, the ShmemContext API, and the fusion layer (`core.fusion`:
ring attention and the fused reduce-scatter -> AdamW, with their
pricing), and the measurement services: the pcontrol profiler
(`core.profile`), the Chrome-trace tracer (`core.trace`) and the measured
tuner (`core.tuner`).  The SPMD backend, the fault injector and elastic
recovery are not ported yet."""
from . import (abmodel, collectives, fault, heap, netops, pattern, profile,
               shmem, team, topology, trace, tuner)
from .fault import DeadlineExceeded, LinkFailure, PEFailure
from .netops import NetOps, NocSimNetOps, SimNetOps
from .pattern import CommPattern, Schedule, Stage, as_pattern, compile_pattern
from .profile import OpSample, Profiler
from .shmem import Ctx, RetryPolicy, ShmemContext, sim_ctx, spmd_ctx
from .team import (Team, TeamPartition, from_active_set, make_team, split_2d,
                   split_strided, team_world)
from .topology import MeshTopology, epiphany3, v5e_multipod, v5e_pod
from .trace import Tracer
from .tuner import TunedSelector, Tuner, TuningDB

__all__ = [
    "abmodel", "collectives", "fault", "heap", "netops", "pattern", "profile",
    "shmem", "team", "topology", "trace", "tuner", "OpSample", "Profiler",
    "Tracer", "TunedSelector", "Tuner", "TuningDB", "DeadlineExceeded", "LinkFailure", "PEFailure",
    "RetryPolicy", "NetOps", "NocSimNetOps", "SimNetOps", "CommPattern",
    "Schedule", "Stage", "as_pattern", "compile_pattern", "Ctx",
    "ShmemContext", "sim_ctx", "spmd_ctx", "Team", "TeamPartition",
    "from_active_set", "make_team", "split_2d", "split_strided",
    "team_world", "MeshTopology", "epiphany3", "v5e_multipod", "v5e_pod",
]

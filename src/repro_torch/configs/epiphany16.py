"""The paper's own platform: 16 PEs on a 4x4 eMesh (Epiphany-III inside
the $99 Parallella): the alpha-beta model constants and the message
sizes of the paper's figures, which `chip_smoke.py` sweeps on the card."""
from ..core.topology import epiphany3
from ..core import abmodel

TOPOLOGY = epiphany3()
N_PES = TOPOLOGY.n_pes          # 16
CLOCK_HZ = 600e6
PUT_LINK = abmodel.EPIPHANY_NOC
GET_LINK = abmodel.EPIPHANY_NOC_GET
# IPI-get interrupt service routine entry cost: ~60 clocks to vector
# into the ISR and decode the request.  The seed used 2e-7 s (120
# clocks), which double-counted entry+exit and pushed the modeled
# IPI-get turnover to 128 B where the paper measures 64 B; at 60 clocks
# the model reproduces the paper's crossover exactly (the gated
# ipi_get_turnover_B fidelity row).
ISR_ENTRY_S = 60 / CLOCK_HZ     # 1e-7 s
# message sizes swept in the paper's figures (bytes)
MSG_SIZES = [8 << i for i in range(12)]   # 8 B .. 16 KB
# paper-reported reference numbers, digitized from the figures/text —
# the values benchmarks/paper_fidelity.py gates model derivations
# against (tolerances + source figures live in its TABLE)
PAPER = {
    "put_peak_GBs": 2.4,          # Fig. 3 / text
    "get_peak_GBs": 0.24,         # Fig. 3: get saturates ~10x below put
    "get_put_ratio": 0.1,         # get ~10x slower
    "put_4096B_us": 1.8,          # Fig. 3, digitized 4 KB put latency
    "get_4096B_us": 17.2,         # Fig. 3, digitized 4 KB get latency
    "put_alpha_us": 0.1,          # Fig. 3, small-message latency intercept
    "elib_barrier_us": 2.0,
    "wand_barrier_us": 0.1,
    "dissem_barrier_us_16pe": 0.23,
    "bcast_GBs_over_log2N": 2.4,  # ~2.4/log2(N) GB/s
    "ipi_get_turnover_B": 64,
    "reduce_knee_B": 256,         # Fig. 8: work-array floor, 64 ints
}

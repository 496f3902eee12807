"""The count functions against the kernel-4 bounds of PERF.md's kernel
table (row 4: kept pairs x 2(D + Dv) x Hq at 989 TFLOP/s), and the
model counts against their definition."""
import pytest

from ptbench import spec
from ptbench.counts import dense as C
from ptbench.peaks import H100


def _arch(hq, hkv, hd, layers=1, **kw):
    return {"hidden_size": hq * hd, "num_attention_heads": hq,
            "num_key_value_heads": hkv, "head_dim": hd,
            "num_hidden_layers": layers, **kw}


@pytest.mark.parametrize("arch,n,ms", [
    (_arch(32, 32, 96), 32768, 6.670648),     # phi-3-vision
    (_arch(48, 8, 128), 32768, 13.341296),    # internlm2
    (_arch(14, 2, 64), 32768, 1.945606),      # the gathered "long" row
    (_arch(32, 32, 64), 32768, 4.447099),     # zamba2
])
def test_kernel4_bounds_of_the_table(arch, n, ms):
    assert C.kept_pairs(n) == 536_887_296
    got = C.bound_seconds(C.attention_flops(arch, n),
                          C.attention_bytes(arch, n), H100)
    assert got * 1e3 == pytest.approx(ms, abs=5e-7)


@pytest.mark.parametrize("name", ["internlm2-20b", "phi-3-vision-4.2b"])
def test_model_counts(name):
    a = spec.config(name)
    d, L = a["hidden_size"], a["num_hidden_layers"]
    hq, hkv, hd = (a["num_attention_heads"], a["num_key_value_heads"],
                   a["head_dim"])
    ff, V = a["intermediate_size"], a["vocab_size"]
    per_layer = d * hq * hd * 2 + d * hkv * hd * 2 + 3 * d * ff
    assert C.matmul_params(a) == per_layer * L
    # the weights: the matmuls, two norms a layer, the embedding and head
    total = C.matmul_params(a) + 2 * V * d
    assert total * (2 if a["torch_dtype"] == "bfloat16" else 4) == \
        pytest.approx({"internlm2-20b": 39.72e9,
                       "phi-3-vision-4.2b": 7.64e9}[name], rel=2e-3)
    # a prefill of n tokens is n tokens' matmuls, its causal attention
    # and one LM head; a decoded token attends over its keys
    n = 300
    assert C.prefill_flops(a, n) == pytest.approx(
        2 * C.matmul_params(a) * n + C.kept_pairs(n) * 4 * hd * hq * L
        + 2 * d * V)
    assert C.token_flops(a, n + 1) - C.token_flops(a, n) == \
        pytest.approx(4 * hd * hq * L)


def test_device_trace_reduction():
    """Busy time is the union of the device's operations; each idle gap
    between them is named by the innermost host operation at its
    midpoint, or the harness phase around it."""
    from ptbench import devtrace
    dev = [(0, 10, "k1"), (5, 20, "k2"), (30, 40, "k1"), (100, 110, "k3")]
    host = [(0, 200, "ptbench.engine_step"), (21, 29, "aten::mm"),
            (60, 90, "aten::copy_"), (0, 200, "outer")]
    out = devtrace.summarize(dev, host, 200e-6)
    assert out["busy_s"] == pytest.approx(40e-6)
    assert out["kernel_s"]["k1"] == pytest.approx(20e-6)
    assert out["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    assert out["idle_gaps"] == [["aten::copy_", pytest.approx(60e-6)],
                                ["aten::mm", pytest.approx(10e-6)]]

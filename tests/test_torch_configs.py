"""Every architecture's config against the reference's, field by field:
each arch's full `CONFIG` and its `smoke()` config, nested configs (MLA,
MoE, SSM) included, with the reference's jnp dtypes mapped to torch's by
name.  The reference's JAX-only fields (`use_pallas`, `probe_unroll`)
have no counterpart in the port."""
import dataclasses

import pytest

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.configs.registry import ARCHS as JARCHS
from repro_torch.configs import ARCHS, get_config, smoke_config

JAX_ONLY = {"use_pallas", "probe_unroll"}


def _fields(cfg) -> dict:
    """A config's fields as plain values: nested dataclasses as dicts,
    dtypes by name (jnp.float32 and torch.float32 both "float32")."""
    out = {}
    for f in dataclasses.fields(cfg):
        if f.name in JAX_ONLY:
            continue
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v)
        elif hasattr(v, "dtype") or "dtype" in f.name:
            v = str(getattr(v, "__name__", v)).replace("torch.", "")
        out[f.name] = v
    return out


def test_the_port_has_every_reference_arch():
    assert sorted(ARCHS) == sorted(JARCHS)


@pytest.mark.parametrize("kind", ["CONFIG", "smoke"])
@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_config_equals_the_reference_field_by_field(arch, kind):
    if kind == "CONFIG":
        got, want = get_config(arch), jget_config(arch)
    else:
        got, want = smoke_config(arch), jsmoke_config(arch)
    assert _fields(got) == _fields(want)

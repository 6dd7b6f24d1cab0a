"""The port's Config, enums and presets equal the JAX package's exactly."""
import dataclasses

import numpy as np
import pytest

from fast_lio_tpu import config as jcfg
from fast_lio_tpu_torch import config as tcfg
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _as_plain(cfg):
    """Config -> dict with enums as ints and arrays as tuples."""
    out = {}
    for k, v in dataclasses.asdict(cfg).items():
        if isinstance(v, np.ndarray):
            v = tuple(v.ravel().tolist())
        elif hasattr(v, "value"):
            v = (type(v).__name__, int(v))
        out[k] = v
    return out


def test_fields_types_and_defaults_equal():
    jf = dataclasses.fields(jcfg.Config)
    tf = dataclasses.fields(tcfg.Config)
    assert [f.name for f in jf] == [f.name for f in tf]
    for a, b in zip(jf, tf):
        assert a.type == b.type, a.name
    assert _as_plain(jcfg.Config()) == _as_plain(tcfg.Config())


def test_enums_equal():
    for name in ("LidarType", "TimeUnit"):
        je, te = getattr(jcfg, name), getattr(tcfg, name)
        assert [(m.name, int(m)) for m in je] == [(m.name, int(m)) for m in te]
    for u in jcfg.TimeUnit:
        assert tcfg.TimeUnit(int(u)).to_ms == u.to_ms


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_preset_equal(name):
    assert sorted(jcfg.PRESETS) == sorted(tcfg.PRESETS)
    j, t = jcfg.PRESETS[name], tcfg.PRESETS[name]
    assert _as_plain(j) == _as_plain(t)
    np.testing.assert_array_equal(j.extrinsic_R_mat, t.extrinsic_R_mat)
    np.testing.assert_array_equal(j.extrinsic_T_vec, t.extrinsic_T_vec)

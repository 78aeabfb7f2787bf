"""``scripts/late_state_parity.py``'s draws and one-ulp fields, on the CPU
(no update runs):

(a) under nbc_unicycle the script's draws for a key are those that
    ``tests/test_torch_port_episode.py`` injects into the port's update
    from the same update key: ``split(key, 8)``'s [2], [3] and [5] for the
    samples, and [4] for the learned barrier's resampled control, shaped
    (1, batch, n_u); [6] joins only where the constraint has a backup
    policy;
(b) under unicycle the draws are the three they always were, [2], [3]
    and [5], and nothing else;
(c) the one-ulp run moves the learned barrier's net under nbc_unicycle
    and not under unicycle, and ``--preset`` takes both presets.

Tolerances: none; every draw is compared bit for bit.
"""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nlbac_tpu_torch import config as tconfig

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "late_state_parity.py"


def _load():
    sys.path.insert(0, str(SCRIPT.parent))
    try:
        spec = importlib.util.spec_from_file_location("late_state_parity",
                                                      SCRIPT)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(SCRIPT.parent))
    return mod


late = _load()
BATCH = 128


def injected(key, n_u, ccfg):
    """The draws ``tests/test_torch_port_episode.py``'s ``JaxDrawsAgent``
    injects from an update's core key."""
    core = jax.random.split(key, 8)

    def normal(i):
        return np.asarray(jax.random.normal(core[i], (BATCH, n_u),
                                            jnp.float32))

    out = {name: normal(i)
           for name, i in (("next", 2), ("pi", 3), ("backup", 5))}
    if ccfg.kind == "learned_barrier":
        out.update({name: normal(i)[None]
                    for name, i in (("resample", 4), ("backup_resample", 6))})
    return out


def _cfg(preset, use_backup=None):
    cfg = tconfig.get_config(preset)
    if use_backup is None:
        return cfg
    return dataclasses.replace(cfg, constraint=dataclasses.replace(
        cfg.constraint, use_backup=use_backup))


@pytest.mark.parametrize("preset, use_backup, names", [
    ("unicycle", None, {"next", "pi", "backup"}),
    ("nbc_unicycle", None, {"next", "pi", "backup", "resample"}),
    ("nbc_unicycle", True, {"next", "pi", "backup", "resample",
                            "backup_resample"}),
])
@pytest.mark.parametrize("seed", [0, 3])
def test_draws_equal_the_episode_tests_injection(preset, use_backup, names,
                                                 seed):
    cfg = _cfg(preset, use_backup)
    key = jax.random.PRNGKey(seed * 100000 + 17)
    n_u = cfg.action_dim
    got = late.draws(key, BATCH, n_u, cfg.constraint)
    assert set(got) == names
    want = injected(key, n_u, cfg.constraint)
    for name, value in got.items():
        shape = (1, BATCH, n_u) if name.endswith("resample") else (BATCH,
                                                                   n_u)
        assert tuple(value.shape) == shape, name
        np.testing.assert_array_equal(value.numpy(), want[name])
    if preset == "unicycle":
        old = late.draws(key, BATCH, n_u)
        assert set(old) == names
        for name in names:
            np.testing.assert_array_equal(old[name].numpy(),
                                          got[name].numpy())


def test_one_ulp_fields_and_presets():
    assert late.trained_fields(_cfg("unicycle")) == late.TRAINED
    assert "barrier" not in late.TRAINED
    assert late.trained_fields(_cfg("nbc_unicycle")) == late.TRAINED + (
        "barrier",)
    assert late.PRESETS == ("unicycle", "nbc_unicycle")

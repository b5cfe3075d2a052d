"""The port's ``FedConfig`` refuses, at construction, every value that the
reference's ``FedConfig`` refuses, with the same ``ValueError`` message,
and constructs every valid setting the reference constructs.  The port
keeps copies of the scenario and defense names until it has those
registries; these tests hold each copy, and the port's sampler registry,
to the reference's registry."""
import pytest

pytest.importorskip("torch")

import repro.configs.base as jcfg  # noqa: E402
import repro_torch.configs.base as tcfg  # noqa: E402
import repro_torch.fed.population as tpopulation  # noqa: E402
from repro.core.robust import DEFENSES  # noqa: E402
from repro.fed.population import SAMPLERS  # noqa: E402
from repro.fed.scenarios import SCENARIOS  # noqa: E402

REJECTED = [
    {"defense": "bogus"},
    {"scenario": "bogus"},
    {"staleness": "bogus"},
    {"cohort_sampler": "bogus"},
    {"speed_dist": "bogus"},
    {"trim_frac": 0.7},
    {"trim_frac": 0.5},
    {"trim_frac": -0.1},
    {"quarantine_window": -1},
    {"krum_f": -1},
    {"defense_clip": -1.0},
    {"quarantine_nonfinite": 0},
    {"quarantine_z": 0.0},
    {"master_dtype": "int8"},
    {"master_dtype": "bogus", "param_layout": "flat"},
    {"param_layout": "tree", "master_dtype": "float32"},
    {"param_layout": "bogus"},
    {"algorithm": "bogus"},
    {"server_opt": "bogus"},
    {"compressor": "bogus"},
    {"weights": "bogus"},
    {"k_mode": "bogus"},
]

VALID = (
    [{"param_layout": "flat", "master_dtype": dt}
     for dt in ("", "float32", "bfloat16", "float16")]
    + [{"cohort_sampler": name} for name in sorted(SAMPLERS)]
    + [{"scenario": name} for name in sorted(SCENARIOS)]
    + [{"defense": name} for name in sorted(DEFENSES)]
    + [{"staleness": name} for name in ("constant", "hinge", "poly")]
    + [{"speed_dist": name} for name in
       ("fixed", "uniform", "lognormal", "bimodal", "trace")]
    + [{"trim_frac": 0.0}, {"trim_frac": 0.49}, {"krum_f": 0},
       {"quarantine_window": 0}, {"quarantine_nonfinite": 1},
       {"quarantine_z": 1e-6}, {"defense_clip": 0.0}])


def _message(module, kw) -> str:
    with pytest.raises(ValueError) as info:
        module.FedConfig(**kw)
    return str(info.value)


@pytest.mark.parametrize("kw", REJECTED, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()))
def test_port_rejects_what_the_reference_rejects(kw):
    assert _message(tcfg, kw) == _message(jcfg, kw)


@pytest.mark.parametrize("kw", VALID, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()))
def test_valid_settings_construct_in_both(kw):
    j, t = jcfg.FedConfig(**kw), tcfg.FedConfig(**kw)
    for field in kw:
        assert getattr(t, field) == getattr(j, field) == kw[field]


@pytest.mark.parametrize("copy,registry", [
    (tpopulation.SAMPLERS, SAMPLERS), (tcfg.SCENARIOS, SCENARIOS),
    (tcfg.DEFENSES, DEFENSES)], ids=["samplers", "scenarios", "defenses"])
def test_name_copies_mirror_the_reference_registries(copy, registry):
    assert sorted(copy) == sorted(registry)

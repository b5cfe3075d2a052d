"""The port's dry run (``repro_torch.launch.dryrun``) and the numpy half of
its roofline (``repro_torch.roofline.analysis``).

One subprocess starts a fake process group of 8 ranks on a ``(4, 2)``
``("data", "model")`` mesh (the fake backend is started only there) and
runs reduced llama3-8b's train, prefill and decode steps through the CLI
and ``run_combo``, the ``long`` kind through ``lower_serve``, and
``lower_population`` / ``lower_personalized_serve``, all on fake
tensors, and traces a toy step whose bytes and peak are known; a MoE arch
is refused.  In the test process: ``skip_reason``
against the reference's long-context set, and the model-FLOP helpers and
``layout_comparison`` against ``repro.roofline.analysis`` on every
registry arch (the time terms scale by the ratio of the two cards'
constants; the byte terms and ratios are equal).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import ARCHS as JARCHS, get_arch as jget_arch  # noqa: E402,E501
from repro.configs.shapes import LONG_CONTEXT_OK as J_LONG_OK  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_arch  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
LIMIT_S = 150

SCRIPT = r"""
import dataclasses, json, sys
from repro_torch.launch import dryrun, serve
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_arch
from repro_torch.configs.shapes import SHAPES
out = sys.argv[1]
dryrun.main(["--arch", "llama3-8b", "--shape", "train_4k", "--mesh", "4x2",
             "--reduced", "--out", out])
recs = [dryrun.run_combo("llama3-8b", s, multi_pod=False, mesh_shape=(4, 2),
                         reduced=True, k_max=2)
        for s in ("prefill_32k", "decode_32k")]
recs.append(dryrun.run_combo("granite-moe-1b-a400m", "train_4k",
                             multi_pod=False, mesh_shape=(4, 2),
                             reduced=True))
mesh = dryrun._mesh(False, "tp16", (4, 2))
shape = dataclasses.replace(SHAPES["long_500k"], seq_len=128, global_batch=1)
cfg = reduced(get_arch("llama3-8b"))
trace, _ = serve.lower_serve(cfg, shape, mesh, kind="long")
traces = {"long": trace}
# the population round (a cohort of 4 over 8 clients' rows) and the
# personalized decode tick, lowered on the same world
from repro_torch.configs.base import FedConfig
from repro_torch.core import flat
from repro_torch.launch import specs, train
small = dataclasses.replace(SHAPES["train_4k"], seq_len=32, global_batch=8)
traces["population"], _ = train.lower_population(
    cfg, small, mesh, FedConfig(algorithm="fedagrac"), m_population=8,
    k_max=2)
fspec = flat.make_flat_spec(specs.abstract_params(cfg))
decode = dataclasses.replace(SHAPES["decode_32k"], seq_len=64,
                             global_batch=8)
traces["personalized"], _ = serve.lower_personalized_serve(cfg, decode, mesh,
                                                           fspec)
# a toy step whose bytes and peak are known
import torch
from repro_torch.roofline import analysis
traces["toy"] = analysis.trace_step(lambda x: (x * 2.0).sum(),
                                    [torch.empty(256, 1024)], [None], mesh)
with open(out, "a") as f:
    for r in recs:
        f.write(json.dumps(r) + "\n")
    for name, trace in traces.items():
        f.write(json.dumps({"shape": name, "status": "ok", "trace": trace})
                + "\n")
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "records.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(out)], env=env,
                          capture_output=True, text=True, timeout=LIMIT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    return {"stdout": proc.stdout, **{r["shape"] if r["status"] != "refused"
                                      else "refused": r for r in recs}}


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_dryrun_reduced_llama_is_ok_on_fake_world(records, shape):
    """Each step ran on the fake 8-rank mesh: ok, FLOPs and bytes counted,
    and collectives where the specs shard (the model axis splits every
    projection, so each step all-reduces or gathers over it)."""
    rec = records[shape]
    assert rec["status"] == "ok", rec.get("traceback", rec)
    assert rec["mesh"] == "4x2"
    rl = rec["roofline"]
    assert rl["flops_per_chip"] > 0 and rl["bytes_per_chip"] > 0
    assert rl["chips"] == 8 and rl["model_flops"] > 0
    assert sum(rec["collective_counts"].values()) > 0
    assert sum(rl["collective_bytes"].values()) > 0
    assert rl["dominant"] in ("compute", "memory", "collective")
    mem = rec["memory"]
    assert mem["peak_bytes_per_rank"] >= mem["argument_size_in_bytes"] > 0


def test_trace_counts_op_bytes_and_the_live_peak(records):
    """``(x · 2).sum()`` on a 1 MiB float32 x: the multiply reads and
    writes 1 MiB, the sum reads 1 MiB and writes 4 bytes, and at the peak
    x, x · 2 and the sum are alive; ``fits`` holds a peak to the card's
    memory."""
    t = records["toy"]["trace"]
    mib = 1 << 20
    assert t["in_bytes"] == mib and t["out_bytes"] == 4
    assert t["op_bytes"] == 3 * mib + 4
    assert t["peak_bytes"] == 2 * mib + 4
    assert analysis.fits({"peak_bytes": analysis.HBM_BYTES})
    assert not analysis.fits({"peak_bytes": analysis.HBM_BYTES + 1})


def test_dryrun_cli_prints_the_reference_line(records):
    line = next(ln for ln in records["stdout"].splitlines()
                if "train_4k" in ln)
    assert line.startswith("[ok     ] llama3-8b"), line
    assert "dominant=" in line and "4x2" in line, line


def test_dryrun_long_kind_shards_the_cache_sequence(records):
    """``long``: one row, the cache's sequence over the 4 data ranks; the
    decode's softmax is combined across them by all-reduces."""
    trace = records["long"]["trace"]
    assert trace["flops"] > 0 and trace["io_bytes"] > 0
    assert trace["collectives"]["count"]["all-reduce"] > 0


@pytest.mark.parametrize("step", ["population", "personalized"])
def test_lower_population_and_personalized_serve_trace(records, step):
    """``lower_population`` (the cohort's rows gathered from and written
    into the row-sharded ν⁽ⁱ⁾ store) and ``lower_personalized_serve``
    (the rows all-gathered over the model axis) run on the fake world,
    their traces counting FLOPs, bytes and collectives."""
    trace = records[step]["trace"]
    assert trace["flops"] > 0 and trace["io_bytes"] > 0
    assert sum(trace["collectives"]["count"].values()) > 0


def test_dryrun_refuses_moe_on_the_mesh(records):
    rec = records["refused"]
    assert rec["status"] == "refused", rec
    assert "ROADMAP A15" in rec["reason"], rec


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_skip_reason_matches_reference_long_context_set(shape):
    for arch in ARCHS:
        skipped = dryrun.skip_reason(arch, shape) is not None
        assert skipped == (shape == "long_500k" and arch not in J_LONG_OK), (
            arch, shape)
    assert dryrun.shape_kind(shape) == {
        "train_4k": "train", "prefill_32k": "prefill",
        "decode_32k": "decode", "long_500k": "long"}[shape]


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_model_flops_and_layout_comparison_match_reference(arch):
    assert arch in ARCHS
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    for fn in ("train_model_flops", "prefill_model_flops",
               "decode_model_flops"):
        assert getattr(analysis, fn)(cfg, 12345) == getattr(
            janalysis, fn)(jcfg, 12345), fn
    coll = {"all-gather": 3 << 20, "all-reduce": 5 << 20,
            "reduce-scatter": 0, "all-to-all": 7, "collective-permute": 0}
    n = cfg.active_param_count()
    tree = (analysis.Roofline(1e12, 8.0 * n, coll, 256),
            janalysis.Roofline(1e12, 8.0 * n, coll, 256))
    flat = (analysis.Roofline(1e12, 6.0 * n, dict(coll, **{"all-gather": 1}),
                              256),
            janalysis.Roofline(1e12, 6.0 * n,
                               dict(coll, **{"all-gather": 1}), 256))
    got = analysis.layout_comparison(tree[0], flat[0], conversion_bytes=n)
    want = janalysis.layout_comparison(tree[1], flat[1], conversion_bytes=n)
    assert got.keys() == want.keys()
    scale = {"t_memory_s": janalysis.HBM_BW / analysis.HBM_BW,
             "t_collective_s": janalysis.ICI_BW / analysis.NVLINK_BW}
    for key, value in want.items():
        factor = next((f for suffix, f in scale.items()
                       if key.endswith(suffix)), 1.0)
        assert got[key] == pytest.approx(value * factor, rel=1e-12), key

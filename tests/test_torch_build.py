"""The port's kernel build (``repro_torch.kernels._build``): a library's
file name hashes its source, the headers beside it, the shared headers
(``kernels/common/csrc``) and the flags, so an edited source or header is
rebuilt and an old build never loads in its place.  Checked on copies of the sources, with nothing compiled.  The
constants that Python code copies from the backward source are held
against it here."""
import importlib.util
import re
import shutil
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ops_ssd  # noqa: E402

ATTN = ("flash_attention", "flash_attention_bwd")
SHARED = ("mma_tiles.cuh", "tf32_tiles.cuh")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """The flash-attention sources, copied under ``tmp_path`` and put in
    place of the package's in ``_build.SOURCES``, and the shared headers,
    copied to ``tmp_path / "common"`` in place of ``_build.COMMON_DIR``."""
    src_dir = _build.SOURCES["flash_attention"].parent
    dst = tmp_path / "csrc"
    shutil.copytree(src_dir, dst)
    shutil.copytree(_build.COMMON_DIR, tmp_path / "common")
    monkeypatch.setattr(_build, "SOURCES", {
        name: dst / _build.SOURCES[name].name for name in ATTN})
    monkeypatch.setattr(_build, "COMMON_DIR", tmp_path / "common")
    return dst


def test_both_attention_sources_include_the_shared_header():
    for name in ATTN:
        assert '#include "mma_tiles.cuh"' in _build.SOURCES[name].read_text()


def test_library_path_is_that_of_the_package_sources(csrc_copy):
    """A byte-identical copy gives the same library (the hash reads bytes
    and header names, not paths)."""
    copied = {name: _build.library_path(name) for name in ATTN}
    shutil.rmtree(csrc_copy)
    shutil.copytree(_build.KERNELS_DIR / "flash_attention" / "csrc",
                    csrc_copy)
    assert {name: _build.library_path(name) for name in ATTN} == copied


@pytest.mark.parametrize("edit", ["header", "new_header", "source", "flags"])
def test_editing_a_header_or_source_changes_library_path(csrc_copy,
                                                         monkeypatch, edit):
    before = {name: _build.library_path(name) for name in ATTN}
    if edit == "header":
        header = csrc_copy.parent / "common" / "mma_tiles.cuh"
        header.write_bytes(header.read_bytes() + b"\n// edited\n")
        changed = set(ATTN)
    elif edit == "new_header":
        (csrc_copy / "extra.cuh").write_text("#pragma once\n")
        changed = set(ATTN)
    elif edit == "source":
        src = csrc_copy / "flash_attention_bwd.cu"
        src.write_bytes(src.read_bytes() + b"\n")
        changed = {"flash_attention_bwd"}
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS",
                            _build.NVCC_FLAGS + ("-lineinfo",))
        changed = set(ATTN)
    after = {name: _build.library_path(name) for name in ATTN}
    for name in ATTN:
        assert (after[name] != before[name]) == (name in changed)
        assert after[name].parent == _build.BUILD_DIR


@pytest.mark.parametrize("edit", ["forward", "backward"])
def test_each_ssd_source_names_its_own_library(tmp_path, monkeypatch, edit):
    """The SSD forward and backward are two libraries, each named by its
    own source's hash: an edit to one renames it alone."""
    names = ("ssd_scan", "ssd_scan_bwd")
    dst = tmp_path / "csrc"
    shutil.copytree(_build.SOURCES["ssd_scan"].parent, dst)
    monkeypatch.setattr(_build, "SOURCES", {
        name: dst / _build.SOURCES[name].name for name in names})
    before = {name: _build.library_path(name) for name in names}
    edited = names[edit == "backward"]
    src = _build.SOURCES[edited]
    src.write_bytes(src.read_bytes() + b"\n")
    after = {name: _build.library_path(name) for name in names}
    assert {name for name in names if after[name] != before[name]} == {
        edited}


@pytest.mark.parametrize("header", SHARED)
def test_editing_a_shared_header_changes_attention_and_ssd_library_paths(
        tmp_path, monkeypatch, header):
    """Both attention libraries and the SSD scan's forward and backward
    include the shared headers: an edit to either changes all four library
    names, so a stale SSD library never survives it."""
    names = ATTN + ("ssd_scan", "ssd_scan_bwd")
    shutil.copytree(_build.COMMON_DIR, tmp_path / "common")
    monkeypatch.setattr(_build, "COMMON_DIR", tmp_path / "common")
    for name in names:
        assert f'#include "{header}"' in _build.SOURCES[name].read_text()
    before = {name: _build.library_path(name) for name in names}
    edited = tmp_path / "common" / header
    edited.write_bytes(edited.read_bytes() + b"\n// edited\n")
    after = {name: _build.library_path(name) for name in names}
    assert all(after[name] != before[name] for name in names)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bwd_constant(pattern: str) -> int:
    (found,) = re.findall(pattern,
                          _build.SOURCES["flash_attention_bwd"].read_text())
    return int(found)


def _body(src: str, head: str) -> str:
    """The text of the function or struct that starts at ``head`` in
    ``src``, to its closing brace at the start of a line."""
    body = src[src.index(head):]
    return body[:re.search(r"\n\};?\n", body).start()]


@pytest.mark.parametrize("constant", [
    "pieces", "head_buckets", "wide_head_dim", "dkv_block_keys",
    "tf32_terms", "tf32_tiles"])
def test_python_copies_of_backward_constants_match_the_source(constant):
    """chip_smoke.py counts the backward kernels' tensor-core work, and
    ops.dkv_split their blocks, from copies of the CUDA sources' template
    constants; each copy equals the value the source has, for the
    bfloat16 instances and for the float32 (3×TF32) ones."""
    smoke = _chip_smoke()
    src = _build.SOURCES["flash_attention_bwd"].read_text()
    if constant == "pieces":
        assert smoke.BWD_PIECES == _bwd_constant(
            r"constexpr int kPieces = (\d+);")
    elif constant == "head_buckets":
        buckets = tuple(int(d) for d in re.findall(
            r"if \(d <= (\d+)\)", _body(src, "cudaError_t by_bucket(")))
        assert smoke.BWD_HEAD_BUCKETS == buckets + (ops.MAX_HEAD_DIM,)
        for launch in ("cudaError_t launch_mma(", "cudaError_t launch_tf32("):
            assert "return by_bucket(p, " in _body(src, launch)
    elif constant == "wide_head_dim":
        for name in ("kDqHalves", "kPasses"):
            assert smoke.BWD_WIDE_HEAD_DIM == _bwd_constant(
                rf"{name} = D <= (\d+) \? 1 : 2;")
    elif constant == "dkv_block_keys":
        warps = _bwd_constant(r"constexpr int kMmaWarps = (\d+);")
        assert re.search(r"kKvBK = 16 \* kMmaWarps;", src)
        assert ops.DKV_BLOCK_KEYS == 16 * warps
    elif constant == "tf32_terms":
        header = (_build.COMMON_DIR / "tf32_tiles.cuh").read_text()
        (terms,) = re.findall(r"constexpr int kTerms = (\d+);", header)
        body = _body(header, "__device__ __forceinline__ void mma_3xtf32(")
        assert smoke.BWD_TF32_TERMS == int(terms)
        assert body.count("mma_tf32(d, ") == int(terms)
    else:
        # the float32 instances take the bfloat16 ones' column halves,
        # passes and dk/dv block keys, so the copies above hold for both
        cfg = _body(src, "struct Tf32Cfg {")
        assert "kDqHalves = BwdCfg<D>::kDqHalves;" in cfg
        assert "kPasses = BwdCfg<D>::kPasses;" in cfg
        assert "kKvBK = 16 * kMmaWarps;" in cfg
        assert len(re.findall(r"kKvBK = 16 \* kMmaWarps;", src)) == 2


@pytest.mark.parametrize("constant", ["fwd_block_rows", "fwd_block_keys",
                                      "fwd_wide_head_dim", "ssd_buckets",
                                      "ssd_row_tile", "ssd_bwd_buckets",
                                      "ssd_bwd_row_tile", "ssd_bwd_terms"])
def test_python_copies_of_forward_and_ssd_constants_match_the_source(
        constant):
    """chip_smoke.py counts the float32 forward's and the SSD kernels'
    tensor-core work (``_ssd_mma_ops``, ``_ssd_bwd_mma_ops``) from copies
    of their sources' tile constants; each copy equals the source's
    value."""
    smoke = _chip_smoke()
    fwd = _build.SOURCES["flash_attention"].read_text()
    ssd = _build.SOURCES["ssd_scan"].read_text()
    bwd = _build.SOURCES["ssd_scan_bwd"].read_text()
    if constant == "fwd_block_rows":
        (warps,) = re.findall(r"constexpr int kMmaWarps = (\d+);", fwd)
        assert "constexpr int kMmaBQ = 16 * kMmaWarps;" in fwd
        assert "load_tile<P, D, kMmaBQ, W, T>" in _body(
            fwd, "    flash_fwd_kernel_tf32(Params p) {")
        assert smoke.FWD_TF32_BLOCK_ROWS == 16 * int(warps)
    elif constant == "fwd_block_keys":
        cfg = _body(fwd, "struct Tf32Cfg {")
        (cut, narrow, wide) = re.findall(
            r"kBKv = D <= (\d+) \? (\d+) : (\d+);", cfg)[0]
        assert smoke.FWD_TF32_BLOCK_KEYS == {
            d: int(narrow) if d <= int(cut) else int(wide)
            for d in smoke.BWD_HEAD_BUCKETS}
    elif constant == "fwd_wide_head_dim":
        (wide,) = re.findall(r"kHalves = D <= (\d+) \? 1 : 2;",
                             _body(fwd, "struct Tf32Cfg {"))
        assert smoke.FWD_TF32_WIDE_HEAD_DIM == int(wide)
    elif constant == "ssd_buckets":
        buckets = tuple(int(d) for d in re.findall(
            r"if \(d <= (\d+)\) return launch<T, \1>",
            _body(ssd, "cudaError_t launch_d(")))
        (last,) = re.findall(r"return launch<T, (\d+)>\(p, flags, stream\);\n}",
                             _body(ssd, "cudaError_t launch_d(") + "\n}")
        (max_dim,) = re.findall(r"constexpr int kMaxDim = (\d+);", ssd)
        assert smoke.SSD_BUCKETS == buckets + (int(last),)
        assert smoke.SSD_BUCKETS[-1] == int(max_dim) == ops_ssd.MAX_DIM
    elif constant == "ssd_row_tile":
        assert "const int Lp = (p.L + 15) / 16 * 16;" in ssd
        assert "const int z0 = 16 * rt;" in ssd
        assert smoke.SSD_ROW_TILE == 16
    elif constant == "ssd_bwd_buckets":
        # the dstate and the chunk kernel each dispatch on the same buckets
        body = _body(bwd, "cudaError_t by_bucket(")
        for launch in ("launch_dstate", "launch_chunk"):
            buckets = tuple(int(d) for d in re.findall(
                rf"if \(d <= (\d+)\) return {launch}<T, \1>", body))
            (last,) = re.findall(
                rf"^\s+return {launch}<T, (\d+)>\(p, stream\);", body, re.M)
            assert smoke.SSD_BUCKETS == buckets + (int(last),)
        (max_dim,) = re.findall(r"constexpr int kMaxDim = (\d+);", bwd)
        assert int(max_dim) == smoke.SSD_BUCKETS[-1]
    elif constant == "ssd_bwd_row_tile":
        (tile,) = re.findall(r"constexpr int kRowTile = (\d+);", bwd)
        assert smoke.SSD_ROW_TILE == int(tile)
        assert "16 * kk" not in _body(bwd, "    ssd_bwd_chunk_kernel(")
        for kernel in ("    ssd_bwd_dstate_kernel(", "    ssd_bwd_chunk_kernel("):
            assert ("(Lc + kRowTile - 1) / kRowTile"
                    in _body(bwd, kernel))
    else:
        # a product of two float32 operands takes BWD_TF32_TERMS TF32
        # products, one with an exact (bfloat16) operand two: the shared
        # header's mma overloads, which the backward calls
        header = (_build.COMMON_DIR / "tf32_tiles.cuh").read_text()
        three = _body(header, "__device__ __forceinline__ void mma_3xtf32(")
        assert three.count("mma_tf32(d, ") == smoke.BWD_TF32_TERMS
        pad = " " * len("__device__ __forceinline__ void mma(")
        for sig, terms in (("const FragA& a,\n" + pad + "const FragB& b) {",
                            smoke.BWD_TF32_TERMS),
                           ("const FragA& a,\n" + pad + "const ExactB& b) {",
                            2),
                           ("const ExactA& a,\n" + pad + "const FragB& b) {",
                            2)):
            body = _body(header, sig)
            calls = body.count("mma_tf32(d, ") or 3 * body.count(
                "mma_3xtf32(d, ")
            assert calls == terms, sig
        assert "tf32::mma(" in bwd and "mma_tf32" not in bwd

"""What surrounds the redesigned per-tile force kernels (near_span and
table_sweep, csrc/tile_sweeps.cu) and runs on the CPU: the heaviest-first
tile order against numpy, the evidence that the near band bears float32
sums (computed here, window by window, and held to a tenth of the kernel's
bound against the float64-summing plain version), and the build table
(every entry point is in its source, a library's file name follows its
source and flags, nothing selects a kernel variant)."""

import re
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from nbody_tpu_torch.config import PRESETS
from nbody_tpu_torch.init import make_initial_state
from nbody_tpu_torch.models.simulation import sort_by_morton
from nbody_tpu_torch.ops import forces
from nbody_tpu_torch.ops.cuda import build, forces as kern

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
NEAR_BOUND = 1e-4           # chip_smoke.BOUNDS["near_span"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_heavy_first_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    work = rng.integers(0, 40, 1954).astype(np.int32)      # many ties
    order = kern.heavy_first(torch.from_numpy(work))
    assert order.dtype == torch.int64 and order.is_contiguous()
    want = np.argsort(-work.astype(np.int64), kind="stable")
    np.testing.assert_array_equal(order.numpy(), want)
    assert np.all(np.diff(work[order.numpy()]) <= 0)


def _bands(cfg):
    state = make_initial_state(cfg, device="cpu")
    codes, perm, _, _ = sort_by_morton(state.pos, cfg)
    ps, ms, cs = forces.pad_sorted(state.pos[perm], state.mass[perm], codes,
                                   cfg.force_tile)
    _, ss, bands, tables = forces.build_bands(ps, ms, cs, cfg)
    return ps, ms, ss, bands, tables


def _near_float32(ps, ms, bands, cfg):
    """The near band with float32 sums only: each window's 128 terms
    added in lane order, then the windows of the tile in list order.  The
    terms are IEEE 1 / sqrt without fusion, not the kernel's fused
    rsqrt.approx terms: this covers the summation alone, and the kernel's
    term error is held on the card by chip_smoke.py."""
    b = cfg.force_tile
    p, m = ps.numpy(), ms.numpy()
    n_src = p.shape[0]
    soft = np.float32(forces.soft_term(cfg))
    first = bands.win_first.numpy()
    mask = bands.win_mask.numpy().astype(np.int64) & 0xFFFFFFFF
    lane = np.arange(forces.SPAN_ALIGN)
    out = np.zeros((n_src, 3), np.float32)
    for t in range(first.shape[0]):
        tgt = p[t * b:(t + 1) * b]
        acc = np.zeros((b, 3), np.float32)
        for k in range(int(bands.win_cnt[t])):
            j = first[t, k] + lane
            live = ((mask[t, lane // 32, k] >> (lane % 32)) & 1) == 1
            live &= j < n_src
            j = np.minimum(j, n_src - 1)
            qm = np.where(live, np.float32(cfg.g) * m[j], np.float32(0))
            d = p[j][None, :, :] - tgt[:, None, :]            # [B, 128, 3]
            d2 = (d * d).sum(axis=2, dtype=np.float32) + soft
            inv = np.float32(1) / np.sqrt(d2)
            w = qm[None, :] * (inv * inv * inv)
            terms = w[:, :, None] * d
            acc += np.cumsum(terms, axis=1, dtype=np.float32)[:, -1]
        out[t * b:(t + 1) * b] = acc
    return torch.from_numpy(out)


@pytest.mark.parametrize("geometry", ["tile512", "tile128"])
def test_near_band_bears_float32_sums(geometry):
    """The near band sums real particles with positive masses, so float32
    sums (128 terms a window, then the tile's windows) stay within a tenth
    of the near kernel's bound of the plain version, measured as
    chip_smoke.py's `compare` measures it; the table band, which holds the
    anti rows, is the one that needs float64 sums."""
    base = PRESETS["v5_bench"]
    cfg = {"tile512": base.replace(n=6000),
           "tile128": base.replace(n=3000, force_tile=128, near_cap=60)}[
               geometry]
    ps, ms, ss, bands, tables = _bands(cfg)
    assert int(bands.win_cnt.sum()) > 0
    near = forces.near_correction_torch(ps, ps, ms, bands.win_first,
                                        bands.win_mask, bands.win_cnt, cfg)
    total = (forces.far_sweep_torch(ps, ss, cfg)
             + forces.table_sweep_torch(ps, tables, cfg) + near)
    got = _near_float32(ps, ms, bands, cfg)
    rel = (got - near).norm(dim=1) / (total.norm(dim=1) + 1e-6)
    assert float(rel.max()) <= NEAR_BOUND / 10, float(rel.max())
    assert float((got - near).abs().max()) > 0      # the sums do differ


@pytest.mark.parametrize("name", sorted(build.LIBRARIES))
def test_every_entry_point_is_defined_in_its_source(name):
    lib = build.LIBRARIES[name]
    text = lib.source.read_text()
    assert lib.source.is_relative_to(REPO / "nbody_tpu_torch" / "csrc")
    for fn, argtypes in lib.signatures.items():
        found = re.search(rf"\bint {fn}\(([^)]*)\)", text)
        assert found, f"{fn} is not defined in {lib.source.name}"
        assert len(found.group(1).split(",")) == len(argtypes), fn


def test_a_library_file_name_follows_its_source_and_flags(tmp_path):
    plain = build.library_path("tile_sweeps")
    assert plain == build.library_path("tile_sweeps")
    assert plain.parent == build.BUILD_DIR
    assert len({build.library_path(n) for n in build.LIBRARIES}) == len(
        build.LIBRARIES)
    lib = build.LIBRARIES["tile_sweeps"]
    edited = tmp_path / lib.source.name
    edited.write_text(lib.source.read_text() + "// edited\n")
    for changed in (lib._replace(source=edited),
                    lib._replace(flags=["-fmad=false"])):
        with mock.patch.dict(build.LIBRARIES, {"tile_sweeps": changed}):
            assert build.library_path("tile_sweeps") != plain


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


def test_nothing_selects_a_kernel_variant():
    """One arithmetic per kernel, in plain code: the sources read no
    macro a build could set, the build passes none, and chip_smoke.py
    reads no argument and no environment variable."""
    for lib in build.LIBRARIES.values():
        text = lib.source.read_text()
        assert "#ifndef" not in text and "#ifdef" not in text, lib.source
        assert not any(f.startswith("-D") for f in lib.flags)
    smoke = Path(_chip_smoke().__file__).read_text()
    assert "sys.argv" not in smoke and "environ" not in smoke


def test_near_bound_is_chip_smokes():
    assert _chip_smoke().BOUNDS["near_span"] == NEAR_BOUND


# a cuobjdump -sass listing cut down to two functions: a loop of 2 pairs
# (one MUFU.RSQ each) at 0x0010-0x0060 and a loop with no MUFU after it
SASS = """
        Function : _ZN12_GLOBAL__N_116far_sweep_kernelEPKfi
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   FADD R2, R3, -R4 ;
        /*0020*/                   MUFU.RSQ R5, R2 ;
        /*0030*/              @!P0 FMUL R6, R5, R5 ;
        /*0040*/                   MUFU.RSQ R7, R2 ;
        /*0050*/                   F2F.F64.F32 R8, R6 ;
        /*0060*/               @P1 BRA 0x10 ;
        /*0070*/                   IADD3 R9, R9, 0x1, RZ ;
        /*0080*/               @P2 BRA 0x70 ;
        /*0090*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_118table_sweep_kernelILi4EEvPKf
        /*0000*/                   EXIT ;
"""


def test_sass_tool_reads_the_pair_loop():
    """tools/sass.py, which PERF.md's instructions-a-pair counts come
    from, on a listing made up here: it splits the functions, takes the
    loop with the MUFU operations and counts per pair."""
    from nbody_tpu_torch.tools import sass

    funcs = sass.functions(SASS)
    assert [n for n in funcs if sass.KERNELS["far_sweep"][1] in n] == [
        "_ZN12_GLOBAL__N_116far_sweep_kernelEPKfi"]
    body = sass.pair_loop(funcs["_ZN12_GLOBAL__N_116far_sweep_kernelEPKfi"])
    assert body[0] == "FADD R2, R3, -R4" and body[-1] == "BRA 0x10"
    pairs, per, ops = sass.per_pair(body)
    assert (pairs, per) == (2, 3.0)
    assert ops == {"FADD": 0.5, "MUFU": 1.0, "FMUL": 0.5, "F2F": 0.5,
                   "BRA": 0.5}
    with pytest.raises(ValueError, match="backward branch"):
        sass.pair_loop(funcs["_ZN12_GLOBAL__N_118table_sweep_kernelILi4EEvPKf"])


@pytest.mark.parametrize("case", ["traced", "no_tie", "tie_not_the_cause"])
def test_far_bit_check_traces_only_tie_caused_differences(case, monkeypatch):
    """chip_smoke.far_bit_check on the CPU, with inv_sqrt_rn replaced by
    IEEE 1 / sqrt made 10^5 ulps low at one argument (a stand-in tie): a
    kernel output that is the list-order float64 sum with that value is
    traced; a one-ulp change with no tie among a target's arguments, or
    at the tie's target but not what the tie makes, fails the check."""
    smoke = _chip_smoke()
    cfg = PRESETS["v5_bench"]
    rng = np.random.default_rng(3)
    n, s, live = 64, 40, 30
    pos = torch.from_numpy(rng.uniform(-1700, 1700, (n, 3)).astype(np.float32))
    com = torch.from_numpy(rng.uniform(-1700, 1700, (s, 3)).astype(np.float32))
    gmass = torch.from_numpy(rng.uniform(1, 1e4, s).astype(np.float32))
    gmass[live:] = 0
    zero = torch.zeros(s)
    ss = forces.Supers(com=com, gmass=gmass, diam=zero, lo=com, hi=com,
                       skin=zero, n_supers=torch.tensor(live))
    soft = forces.soft_term(cfg)

    def args(i):
        d = com[:live] - pos[i]
        return d, d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2] \
            + soft

    tie_at = args(5)[1][3].view(torch.int32)

    def fake_rn(x):
        y = 1.0 / torch.sqrt(x)
        low = (y.view(torch.int32) - 100_000).view(torch.float32)
        return torch.where(x.view(torch.int32) == tie_at, low, y)

    monkeypatch.setattr(kern, "inv_sqrt_rn", fake_rn)
    plain = forces.far_sweep_torch(pos, ss, cfg)
    k_out = plain.clone()
    d, x = args(5)
    inv = fake_rn(x)
    k_out[5] = smoke.list_order_sum((gmass[:live] * (inv * inv * inv))[:, None]
                                    * d)
    assert (k_out != plain).any(dim=1).nonzero().flatten().tolist() == [5]
    if case == "traced":
        assert smoke.far_bit_check("t", k_out, plain, pos, ss, cfg) == 1
        return
    i = 7 if case == "no_tie" else 5
    k_out[i, 1] = torch.nextafter(k_out[i, 1], torch.tensor(1e30))
    with pytest.raises(RuntimeError, match=rf"targets \[{i}\] not traced"):
        smoke.far_bit_check("t", k_out, plain, pos, ss, cfg)

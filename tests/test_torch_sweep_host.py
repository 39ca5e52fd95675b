"""The sweep kernel's arithmetic rehearsed on the CPU.

``csrc/ax_families.cuh`` and ``csrc/sweep_stats.cuh`` hold the per-value
preps, the per-pair combine and the statistics of ``csrc/tuning_sweep.cu`` as
``__host__ __device__`` inline functions; here they are compiled as plain
C++ with ``g++ -O2 -ffp-contract=off`` (no FMA contraction, as on the card)
and bound with ``ctypes``:

- (a) every family's prep + combine, for all REGISTRY descriptors and a
  LUT: exhaustive at 8 bits, 4096 seeded pairs at 12 and 16 bits, equal to
  ``AxMult.fn`` bit for bit;
- (b) a serial host sweep through the kernel's own column loop, groups and
  fixed-order combine (the block's split of the columns and its warp tree
  replayed), held to ``kernels/ref.py::tuning_sweep_ref``: integer stats
  equal, ``sq``/``rel`` within 1e-6 relative.

Runs where ``g++`` is on the path (decided when the test runs):

    PYTHONPATH=src python -m pytest -q tests/test_torch_sweep_host.py
"""
import ctypes
import shutil
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import repro_torch.core as T
import repro_torch.kernels  # noqa: F401  (loads the submodules below)
from repro_torch.kernels import _build
from repro_torch.kernels.ref import tuning_sweep_ref

TS = sys.modules["repro_torch.kernels.tuning_sweep"]
RTOL = 1e-6
H100_SMS = 132

# The host harness: the kernel's block replayed serially.  Thread t of a
# block owns row t % R and split t / R; its columns per staged tile go
# through sweep::columns, and the partials of one row combine as the kernel
# combines them: lanes by __shfl_down_sync at offsets 16, 8, ..., R (lane l
# takes lane l + off's value from before the step), then warps in order.
HARNESS = r"""
#include <stdint.h>
#include <string.h>
#include <vector>
#include "sweep_stats.cuh"

using namespace sweep;

extern "C" int eval_pairs(int bits, int is_signed, int family, int p0, int p1,
                          const int32_t* table, int n, const int32_t* a,
                          const int32_t* b, uint32_t* out) {
  const axf::Params p{bits, p0, p1, table};
  return axf::dispatch(family, is_signed, p, [&](auto fam) {
    using F = decltype(fam);
    for (int i = 0; i < n; ++i)
      out[i] = F::combine(F::prep_x(a[i], p), F::prep_y(b[i], p), p);
  }) ? 0 : -1;
}

extern "C" int host_sweep(int bits, int is_signed, int family, int p0, int p1,
                          const int32_t* table, int n, const int32_t* vals, int nrows,
                          const int32_t* rows, int rshift, uint32_t* u, int32_t* cnt,
                          float* f) {
  const axf::Params p{bits, p0, p1, table};
  return axf::dispatch(family, is_signed, p, [&](auto fam) {
    using F = decltype(fam);
    const int R = 1 << rshift, S = kThreads >> rshift;
    std::vector<Val<F>> col(n);
    for (int j = 0; j < n; ++j) col[j] = make_val<F>(vals[j], p);
    for (int i = 0; i < nrows; ++i) {
      const int row = rows[i], r = row & (R - 1);
      const Val<F> a = make_val<F>(vals[row], p);
      std::vector<Acc> lanes(kThreads);
      for (auto& s : lanes) clear(s);
      for (int split = 0; split < S; ++split) {
        Acc& s = lanes[r + split * R];
        for (int j0 = 0; j0 < n; j0 += kTile) {
          const int cols = n - j0 < kTile ? n - j0 : kTile;
          columns<F>(s, a, col.data() + j0, split, cols, S, p);
        }
      }
      for (int w = 0; w < kThreads / 32; ++w) {
        Acc* warp = lanes.data() + 32 * w;
        for (int off = 16; off >= R; off >>= 1)
          for (int l = 0; l + off < 32; ++l) merge(warp[l], warp[l + off]);
      }
      Acc tot = lanes[r];
      for (int w = 1; w < kThreads / 32; ++w) merge(tot, lanes[32 * w + r]);
      for (int k = 0; k < 3; ++k) {
        u[(k * 3 + 0) * nrows + i] = tot.lo[k];
        u[(k * 3 + 1) * nrows + i] = tot.hi[k];
        u[(k * 3 + 2) * nrows + i] = tot.mx[k];
        cnt[k * nrows + i] = tot.cnt[k];
        f[(k * 2 + 0) * nrows + i] = static_cast<float>(tot.sq[k]);
        f[(k * 2 + 1) * nrows + i] = static_cast<float>(tot.rel[k]);
      }
    }
  }) ? 0 : -1;
}
"""

_P = ctypes.c_void_p
_I = ctypes.c_int


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the sweep's headers as host C++")
    out = tmp_path_factory.mktemp("sweep_host")
    src = out / "harness.cpp"
    src.write_text(HARNESS)
    so = out / "libsweep_host.so"
    cmd = [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
           "-Wno-unknown-pragmas", "-I", str(_build.CSRC), "-o", str(so), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr
    lib = ctypes.CDLL(str(so))
    lib.eval_pairs.argtypes = [_I] * 5 + [_P, _I, _P, _P, _P]
    lib.eval_pairs.restype = _I
    lib.host_sweep.argtypes = [_I] * 5 + [_P, _I, _P, _I, _P, _I, _P, _P, _P]
    lib.host_sweep.restype = _I
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _desc_args(m):
    """(bits, signed, family code, p0, p1, table array or None)."""
    family, p0, p1, _ = TS._kernel_args(m, torch.device("cpu"))
    table = None
    if m.desc[0] == "lut":
        table = np.frombuffer(m.desc[3][0], dtype="<i4").copy()
    return m.bits, int(m.signed), family, p0, p1, table


def _lut():
    base = T.get("mul8s_drum3_4")
    return T.lut_mult("lut_mul8s_drum3_4", T.make_lut(base), True)


# broken arrays beyond the REGISTRY: 16 masked rows (the most a 16-bit
# width gives), 11, v above the width, h above v
EXTRA = {"bam16u_v16_h0": (16, 16, 0, False), "bam16s_v12_h1": (16, 12, 1, True),
         "bam8u_v10_h0": (8, 10, 0, False), "bam12u_v2_h5": (12, 2, 5, False)}


def _mults():
    return [pytest.param(name, id=name) for name in [*T.REGISTRY, "lut", *EXTRA]]


def _get(name):
    if name in EXTRA:
        bits, v, h, signed = EXTRA[name]
        return T.broken_array(bits, v, h, signed)
    return _lut() if name == "lut" else T.get(name)


def _range(m):
    return (-(1 << (m.bits - 1)), 1 << (m.bits - 1)) if m.signed else (0, 1 << m.bits)


@pytest.mark.parametrize("name", _mults())
def test_prep_and_combine_equal_the_multiplier(lib, name):
    m = _get(name)
    lo, hi = _range(m)
    if m.bits == 8:
        v = np.arange(lo, hi, dtype=np.int32)
        a, b = np.repeat(v, v.size), np.tile(v, v.size)
    else:
        rng = np.random.default_rng(m.bits * 7 + int(m.signed))
        a = rng.integers(lo, hi, 4096).astype(np.int32)
        b = rng.integers(lo, hi, 4096).astype(np.int32)
        edge = np.array([lo, hi - 1, 0, 1, -1 if m.signed else 2], dtype=np.int32)
        a = np.concatenate([a, np.repeat(edge, edge.size)])
        b = np.concatenate([b, np.tile(edge, edge.size)])
    bits, signed, fam, p0, p1, table = _desc_args(m)
    out = np.zeros(a.size, dtype=np.uint32)
    rc = lib.eval_pairs(bits, signed, fam, p0, p1, None if table is None else _ptr(table),
                        a.size, _ptr(a), _ptr(b), _ptr(out))
    assert rc == 0
    want = m.fn(torch.from_numpy(a).long(), torch.from_numpy(b).long()).numpy() & 0xFFFFFFFF
    np.testing.assert_array_equal(out.astype(np.int64), want, err_msg=name)


def _host_sweep(lib, m, vals: np.ndarray, rows: np.ndarray, rshift: int) -> dict:
    bits, signed, fam, p0, p1, table = _desc_args(m)
    k = rows.size
    u = np.zeros((3, 3, k), dtype=np.uint32)
    cnt = np.zeros((3, k), dtype=np.int32)
    f = np.zeros((3, 2, k), dtype=np.float32)
    rc = lib.host_sweep(bits, signed, fam, p0, p1, None if table is None else _ptr(table),
                        vals.size, _ptr(vals), k, _ptr(rows), rshift, _ptr(u), _ptr(cnt),
                        _ptr(f))
    assert rc == 0
    return {surf: dict(lo=u[i, 0], hi=u[i, 1], mx=u[i, 2], cnt=cnt[i], sq=f[i, 0],
                       rel=f[i, 1]) for i, surf in enumerate(TS.SURF_NAMES)}


def _hold(got, want, label):
    for surf in TS.SURF_NAMES:
        for st in TS.STAT_NAMES:
            x, y = got[surf][st], want[surf][st].numpy()
            if st in ("sq", "rel"):
                np.testing.assert_allclose(x, y, rtol=RTOL, atol=0, err_msg=f"{label} {surf}.{st}")
            else:
                np.testing.assert_array_equal(x.astype(np.int64), y.astype(np.int64),
                                              err_msg=f"{label} {surf}.{st}")


@pytest.mark.parametrize("name", _mults())
def test_host_sweep_equals_plain(lib, name):
    """N in {1, 31, 256, 300}, values seeded over the multiplier's range
    (repeats allowed), the kernel's split for each N on 132 SMs and every
    other split at N = 300."""
    m = _get(name)
    lo, hi = _range(m)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    for n in (1, 31, 256, 300):
        vals = rng.integers(lo, hi, n).astype(np.int32)
        rows = np.arange(n, dtype=np.int32)
        want = tuning_sweep_ref(m, torch.from_numpy(vals))
        shifts = range(TS.MAX_RSHIFT + 1) if n == 300 else [TS.plan(n, H100_SMS)]
        for rshift in shifts:
            _hold(_host_sweep(lib, m, vals, rows, rshift), want, f"{name} N={n} rshift={rshift}")


@pytest.mark.parametrize("name", ["mul16u_trunc0_8", "mul16u_drum2_14", "mul16s_trunc0_8",
                                  "mul16s_bam_v4_h1", "mul16s_drum5_8", "mul16s_mitch10_13",
                                  "mul16s_trunc4_4"])
def test_host_sweep_16_bit_rows_equal_plain(lib, name):
    """64 seeded rows of an exhaustive 16-bit sweep (N = 65536), the
    kernel's split at that N."""
    m = T.get(name)
    vals = T.operand_values(16, m.signed)
    rows = np.sort(np.random.default_rng(16).choice(vals.size, 64, replace=False)).astype(np.int32)
    want = tuning_sweep_ref(m, torch.from_numpy(vals), rows=torch.from_numpy(rows).long())
    got = _host_sweep(lib, m, vals, rows, TS.plan(vals.size, H100_SMS))
    _hold(got, want, name)


def test_plan_fills_the_card():
    assert TS.plan(65536, H100_SMS) == 5            # 2048 blocks of 32 rows
    assert TS.plan(4096, H100_SMS) == 3             # 512 blocks of 8 rows
    assert TS.plan(256, H100_SMS) == 0              # one row a block
    for n in (1, 31, 300, 512, 1024, 65536):
        rs = TS.plan(n, H100_SMS)
        assert 0 <= rs <= TS.MAX_RSHIFT
        assert rs == 0 or -(-n >> rs) >= 2 * H100_SMS


@pytest.mark.parametrize("name,want", [
    ("mul8u_trunc0_4", "Trunc<false>"), ("mul16s_trunc4_4", "Trunc<true>"),
    ("mul16s_bam_v4_h1", "BrokenArray<true, 3>"), ("bam16u_v16_h0", "BrokenArray<false, 16>"),
    ("bam12u_v2_h5", "BrokenArray<false, 0>"), ("mul8s_exact", "Exact"),
    ("mul16u_exact", "Exact"), ("lut", "Lut<true>"), ("mul16s_mitch10_13", "Mitchell<true>"),
    ("mul12u_drum4_6", "Drum<false>")])
def test_instance_names_the_family_type(name, want):
    assert TS.instance(_get(name)) == want

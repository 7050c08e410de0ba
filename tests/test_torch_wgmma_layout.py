"""The head-dim-128 plumbing of the wgmma kernels
(ray_tpu_torch/ops/csrc/flash_attention.cu), known without a card.

1. Routing: bf16 head dims 65-128 launch the forward, dq and dk/dv
   entries of flash_attention.cu at head dim 128; bf16 up to 64 keeps its
   entries there, and f32 its entries of flash_attention_f32.cu.
2. A numpy model of the shared-memory layout, with the kernel's constants
   read from its source. TMA's 128-byte swizzle takes boxes one 128-byte
   row (64 bf16) wide, so a [rows, 128] tile lands as two [rows, 64]
   halves, half h at h * rows * 128 bytes; inside each, element (r, c) of
   the box is at address a = base + 128 r + 2 c with bits 4-6 XORed by
   bits 7-9 (the swizzle's period of 1024 bytes; the bases are 1024-byte
   aligned). wgmma reads through descriptors (start address, stride byte
   offset between 8-row groups, layout "128-byte swizzle"), applying the
   same XOR to the address it computes: a K-major operand's element
   (m, k) of a k-step at start + SBO (m / 8) + 128 (m % 8) + 2 k, an
   MN-major one's element (k, n) at start + SBO (k / 8) + 128 (k % 8) +
   2 n. The model checks that the two boxes cover every element of the
   tile once, that K-major k-steps 0-3 read half 0 and 4-7 half 1, that
   each MN-major N half reads its own half, and that q.k^T, p.v, k.q^T,
   p^T.do, do.v^T and ds.k come out exact on small integers at the
   kernels' tile shapes and stage offsets; that stepping k-steps 4-7 on by
   +2 past column 64, as at head dim 64, would not; and that the dq
   kernel's shared memory at head dim 128 fits one block.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as tfa

CSRC = Path(tfa.__file__).resolve().parent / "csrc"
SRC = (CSRC / "flash_attention.cu").read_text()


# ------------------------------------------------------------- 1. routing
def _launched(monkeypatch, dtype, Dh):
    """The (entry, counter, arguments) that each wrapper would launch for [2, 40, Dh] tensors of ``dtype``, with the launch itself
    replaced by a record (the kernels run only on the card)."""
    calls = []
    monkeypatch.setattr(tfa, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(tfa, "_launch", lambda entry, counter, device, *args:
                        calls.append((entry, counter, args)))
    q, k, v, do = (torch.zeros(2, 40, Dh, dtype=dtype) for _ in range(4))
    lse, delta = torch.zeros(2, 40), torch.zeros(2, 40)
    kw = dict(scale=1.0, causal=True)
    tfa.flash_fwd(q, k, v, **kw)
    tfa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    tfa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return calls


def _c_entries(lib):
    """{name: argument count} of the extern "C" entries of csrc/<lib>.cu."""
    text = (CSRC / f"{lib}.cu").read_text()
    text = text[text.index('extern "C" {'):]
    return {m.group(1): len(m.group(2).split(","))
            for m in re.finditer(r"^int (flash_\w+)\(([^)]*)\)", text, re.M)}


@pytest.mark.parametrize("dtype,Dh,want", [
    (torch.bfloat16, 65, {"flash_fwd_bf16w": "flash_attention",
                          "flash_bwd_dq_bf16w": "flash_attention",
                          "flash_bwd_dkv_bf16w": "flash_attention"}),
    (torch.bfloat16, 128, {"flash_fwd_bf16w": "flash_attention",
                           "flash_bwd_dq_bf16w": "flash_attention",
                           "flash_bwd_dkv_bf16w": "flash_attention"}),
    (torch.bfloat16, 64, {"flash_fwd_bf16": "flash_attention",
                          "flash_bwd_dq_bf16": "flash_attention",
                          "flash_bwd_dkv_bf16": "flash_attention"}),
    (torch.float32, 100, {"flash_fwd_f32": "flash_attention_f32",
                          "flash_bwd_dq_f32": "flash_attention_f32",
                          "flash_bwd_dkv_f32": "flash_attention_f32"}),
])
def test_each_entry_launches_from_its_library(monkeypatch, dtype, Dh, want):
    """Each wrapper launches the entry of its family from the library that
    defines it, with the arguments that entry takes; the counters keep
    their names (flash_fwd_bf16w, ...)."""
    calls = _launched(monkeypatch, dtype, Dh)
    assert {entry: tfa._LIBRARY_OF[entry] for entry, _, _ in calls} == want
    family, Dk = tfa.kernel_plan(dtype, Dh)
    suffix = tfa._SUFFIXES[family]
    assert [c for _, c, _ in calls] == [
        f"{k}{suffix}" for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]
    for entry, _, args in calls:
        lib = tfa._LIBRARY_OF[entry]
        # the C entry exists in that library's source, with the arguments
        # the wrapper passes (+ the stream, which _launch adds)
        assert _c_entries(lib)[entry] == len(args) + 1
        assert len(tfa._ENTRIES[lib][entry]) == len(args) + 1
        if family != "bf16":
            assert args[-3] == Dk  # the head dim, before scale and causal


def test_bf16_wide_forward_and_dkv_left_the_f32_library():
    """All three bf16_wide kernels have left the f32 file: it holds f32
    entries only, no bf16 instance and no SIMT forward, and
    flash_attention.cu has the head-dim-128 forward, dq and dk/dv."""
    f32_entries, wgmma_entries = (_c_entries("flash_attention_f32"),
                                  _c_entries("flash_attention"))
    wide = {"flash_fwd_bf16w", "flash_bwd_dq_bf16w", "flash_bwd_dkv_bf16w"}
    assert not wide & set(f32_entries)
    assert wide <= set(wgmma_entries)
    assert all(e.endswith("_f32") or e == "flash_f32_kernel_attributes"
               for e in f32_entries), f32_entries
    assert set(tfa._ENTRIES["flash_attention_f32"]) == set(f32_entries)
    f32_src = (CSRC / "flash_attention_f32.cu").read_text()
    assert "__nv_bfloat16" not in f32_src and "cuda_bf16.h" not in f32_src
    assert "flash_fwd_simt_kernel" not in f32_src
    assert set(f32_entries) | set(wgmma_entries) | set(
        _c_entries("flash_attention_dsplit")) >= {
        tfa._entry(c) for c in tfa.LAUNCHES}


# -------------------------------------------------- 2. the layout model
def _cu_int_expr(expr, env):
    """A C++ integer expression of the source (it may span lines),
    evaluated in integers."""
    return int(eval(" ".join(expr.split()).replace("/", "//"), {}, dict(env)))


def _cu_int(name, env):
    """A constexpr of flash_attention.cu, evaluated in integers."""
    m = re.search(rf"constexpr (?:int|uint64_t) {name} = ([^;]+);", SRC)
    assert m, name
    return _cu_int_expr(m.group(1), env)


C = {}
for _name in ("kHalfD", "kRowBytes", "kBlockM", "kFwdBlockN", "kDqBlockN",
              "kDqStages", "kDkvBlockN", "kDescK16", "kDescMN16",
              "kKStepsPerHalf"):
    C[_name] = _cu_int(_name, C)
# the stride byte offset that sw128_desc encodes
SBO = int(re.search(r"\(uint64_t\)\((\d+) >> 4\) << 32", SRC).group(1))
D = 128


def test_the_mirrored_constants():
    assert C == {"kHalfD": 64, "kRowBytes": 128, "kBlockM": 128,
                 "kFwdBlockN": 64, "kDqBlockN": 64, "kDqStages": 4,
                 "kDkvBlockN": 64, "kDescK16": 2, "kDescMN16": 128,
                 "kKStepsPerHalf": 4}
    assert SBO == 1024
    assert "return (uint64_t)(rows * kRowBytes) >> 4;" in SRC  # half_desc


def swizzle(addr):
    """The 128-byte swizzle of a shared-memory byte address."""
    return addr ^ (((addr >> 7) & 7) << 4)


def sw128_desc(saddr):
    """Mirrors sw128_desc of the kernel."""
    return ((saddr & 0x3FFFF) >> 4) | (1 << 16) | ((SBO >> 4) << 32) | (1 << 62)


def half_desc(rows):
    return (rows * C["kRowBytes"]) >> 4


def decode(desc):
    """(start address, stride byte offset) of a 128-byte-swizzle
    descriptor."""
    assert desc >> 62 == 1 and (desc >> 16) & 0x3FFF == 1
    return (desc & 0x3FFF) << 4, ((desc >> 32) & 0x3FFF) << 4


class Smem:
    """Shared memory as a map from byte address to the (tile, row, column)
    of the bf16 element that starts there, and its value."""

    def __init__(self):
        self.at = {}

    def tma_tile(self, base, name, x):
        """TMA's loads of a [rows, D] tile x: one [rows, 64] box a half of
        D, half h at base + h * rows * 128 (tma_load_tile)."""
        rows, cols = x.shape
        assert base % 1024 == 0
        for h in range(cols // C["kHalfD"]):
            dst = base + h * rows * C["kRowBytes"]
            for r in range(rows):
                for c in range(C["kHalfD"]):
                    a = swizzle(dst + r * C["kRowBytes"] + 2 * c)
                    assert a not in self.at
                    col = h * C["kHalfD"] + c
                    self.at[a] = (name, r, col, x[r, col])

    def read_k_major(self, desc, rows):
        """A K-major operand of one k-step ([rows, 16]): element (m, k) at
        start + SBO (m / 8) + 128 (m % 8) + 2 k, swizzled."""
        start, sbo = decode(desc)
        return [[self.at[swizzle(start + sbo * (m // 8) + C["kRowBytes"] *
                                 (m % 8) + 2 * k)] for k in range(16)]
                for m in range(rows)]

    def read_mn_major(self, desc, n):
        """An MN-major operand of one k-step ([16, n], n <= 64): element
        (k, n) at start + SBO (k / 8) + 128 (k % 8) + 2 n, swizzled."""
        start, sbo = decode(desc)
        assert n <= C["kHalfD"]
        return [[self.at[swizzle(start + sbo * (k // 8) + C["kRowBytes"] *
                                 (k % 8) + 2 * j)] for j in range(n)]
                for k in range(16)]


def values(cells):
    return np.array([[cell[3] for cell in row] for row in cells])


def issue_abt(smem, desc_a, half_a, rows_a, desc_b, half_b, rows_b,
              k_step=None):
    """issue_abt of the kernel: d = A.B^T over D, k-steps 0-3 in half 0 and
    4-7 in half 1. Returns d and the (tile, half) each k-step read.
    ``k_step`` replaces the kernel's descriptor offset of a k-step."""
    d = np.zeros((rows_a, rows_b), dtype=np.int64)
    read = []
    for kk in range(D // 16):
        h = kk // C["kKStepsPerHalf"]
        if k_step is None:
            off_a = h * half_a + (kk % C["kKStepsPerHalf"]) * C["kDescK16"]
            off_b = h * half_b + (kk % C["kKStepsPerHalf"]) * C["kDescK16"]
        else:
            off_a = off_b = k_step(kk)
        a = smem.read_k_major(desc_a + off_a, rows_a)
        b = smem.read_k_major(desc_b + off_b, rows_b)
        read.append({(cell[0], cell[2] // C["kHalfD"]) for row in a + b
                     for cell in row})
        d += values(a) @ values(b).T
    return d, read


def issue_ab(smem, a, desc_b, half_b):
    """issue_ab of the kernel: d += A.B over kK rows, A in registers, B
    read MN-major, one 64-column product a half of D. Returns d and the
    columns of B each half's product read."""
    kK = a.shape[1]
    d = np.zeros((a.shape[0], D), dtype=np.int64)
    cols = {}
    for kk in range(kK // 16):
        for h in range(D // C["kHalfD"]):
            b = smem.read_mn_major(desc_b + h * half_b + kk * C["kDescMN16"],
                                   C["kHalfD"])
            assert {cell[1] for row in b for cell in row} == set(
                range(16 * kk, 16 * kk + 16))  # the k-step's rows of B
            cols.setdefault(h, set()).update(cell[2] for row in b
                                             for cell in row)
            d[:, h * C["kHalfD"]:(h + 1) * C["kHalfD"]] += (
                a[:, 16 * kk:16 * kk + 16] @ values(b))
    return d, cols


def _ints(rng, *shape):
    return rng.integers(-8, 9, size=shape).astype(np.int64)


def test_two_boxes_cover_a_tile_once():
    """Each [rows, 128] tile at the kernels' shapes fills rows * 256 bytes
    exactly, each element once, half h in its own rows * 128 bytes."""
    rng = np.random.default_rng(0)
    for rows in (C["kBlockM"], C["kFwdBlockN"], C["kDkvBlockN"]):
        smem = Smem()
        x = _ints(rng, rows, D)
        smem.tma_tile(4096, "x", x)
        assert sorted(smem.at) == list(range(4096, 4096 + rows * 2 * D, 2))
        assert sorted((r, c) for _, r, c, _ in smem.at.values()) == [
            (r, c) for r in range(rows) for c in range(D)]
        for a, (_, _, c, _) in smem.at.items():
            assert (a - 4096) // (rows * C["kRowBytes"]) == c // C["kHalfD"]


def test_forward_products_at_head_dim_128():
    """The forward's s = q.k^T (each warpgroup's 64 Q rows of the 128-row
    Q tile against a 64-row K stage) and o += p.v (p in registers, the
    64-row V stage MN-major), exact, as the kernel's descriptors read
    them."""
    rng = np.random.default_rng(1)
    q, k, v = (_ints(rng, n, D) for n in (C["kBlockM"], C["kFwdBlockN"],
                                          C["kFwdBlockN"]))
    sQ = 1024
    sK = sQ + C["kBlockM"] * D * 2
    sV = sK + 4 * C["kFwdBlockN"] * D * 2 + C["kFwdBlockN"] * D * 2  # stage 1
    smem = Smem()
    smem.tma_tile(sQ, "q", q)
    smem.tma_tile(sK, "k", k)
    smem.tma_tile(sV, "v", v)
    for wg in (0, 1):
        desc_q = sw128_desc(sQ + wg * 64 * C["kRowBytes"])
        s, read = issue_abt(smem, desc_q, half_desc(C["kBlockM"]), 64,
                            sw128_desc(sK), half_desc(C["kFwdBlockN"]),
                            C["kFwdBlockN"])
        np.testing.assert_array_equal(s, q[64 * wg:64 * wg + 64] @ k.T)
        assert read == [{("q", kk // 4), ("k", kk // 4)} for kk in range(8)]
    p = _ints(rng, 64, C["kFwdBlockN"])
    o, cols = issue_ab(smem, p, sw128_desc(sV), half_desc(C["kFwdBlockN"]))
    np.testing.assert_array_equal(o, p @ v)
    assert cols == {0: set(range(64)), 1: set(range(64, 128))}


def test_dkv_products_at_head_dim_128():
    """dk/dv's transposed scores s^T = k.q^T (each warpgroup's 64 KV rows
    of the 128-row K tile against a 64-row Q stage) and dv += p^T.do (4
    k-steps over the Q rows, dO MN-major), exact."""
    rng = np.random.default_rng(2)
    n = C["kDkvBlockN"]
    k, q, do = _ints(rng, C["kBlockM"], D), _ints(rng, n, D), _ints(rng, n, D)
    sK = 1024
    sQ = sK + 2 * C["kBlockM"] * D * 2 + 3 * n * D * 2  # stage 3
    sdO = sQ + 4 * n * D * 2
    smem = Smem()
    smem.tma_tile(sK, "k", k)
    smem.tma_tile(sQ, "q", q)
    smem.tma_tile(sdO, "do", do)
    for wg in (0, 1):
        st, read = issue_abt(smem, sw128_desc(sK + wg * 64 * C["kRowBytes"]),
                             half_desc(C["kBlockM"]), 64, sw128_desc(sQ),
                             half_desc(n), n)
        np.testing.assert_array_equal(st, k[64 * wg:64 * wg + 64] @ q.T)
        assert read == [{("k", kk // 4), ("q", kk // 4)} for kk in range(8)]
    pt = _ints(rng, 64, n)
    dv, cols = issue_ab(smem, pt, sw128_desc(sdO), half_desc(n))
    np.testing.assert_array_equal(dv, pt @ do)
    assert cols == {0: set(range(64)), 1: set(range(64, 128))}


def test_k_steps_past_column_64_need_the_second_half():
    """At head dim 64 a k-step advances the start address by 32 bytes
    (+2). Carried on past column 64 (k-steps 4-7 at +8..+14 from half 0's
    base), the reads land in other rows of the tile, not in columns 64-127:
    the product is wrong. The kernel steps to half 1's base instead."""
    rng = np.random.default_rng(3)
    q, k = _ints(rng, 64, D), _ints(rng, 64, D)
    smem = Smem()
    smem.tma_tile(1024, "q", q)
    smem.tma_tile(1024 + 64 * D * 2, "k", k)
    s, _ = issue_abt(smem, sw128_desc(1024), 0, 64,
                     sw128_desc(1024 + 64 * D * 2), 0, 64,
                     k_step=lambda kk: kk * C["kDescK16"])
    assert not np.array_equal(s, q @ k.T)


def test_dq_products_at_head_dim_128():
    """dq's s = q.k^T and dp = do.v^T (each warpgroup's 64 rows of the
    128-row Q and dO tiles against a 64-row K or V stage, K-major, k-steps
    4-7 on half 1) and dq += ds.k (ds in registers, the same K stage read
    MN-major, one m64n64k16 a half of D), exact, at the kernel's stage
    offsets."""
    rng = np.random.default_rng(4)
    n, m = C["kDqBlockN"], C["kBlockM"]
    q, do = _ints(rng, m, D), _ints(rng, m, D)
    k, v = _ints(rng, n, D), _ints(rng, n, D)
    sQ = 1024
    sdO = sQ + m * D * 2
    stage, kv_bytes = 2, n * D * 2
    sK = sdO + m * D * 2 + stage * kv_bytes
    sV = sdO + m * D * 2 + C["kDqStages"] * kv_bytes + stage * kv_bytes
    smem = Smem()
    for base, name, x in ((sQ, "q", q), (sdO, "do", do), (sK, "k", k),
                          (sV, "v", v)):
        smem.tma_tile(base, name, x)
    for wg in (0, 1):
        rows = slice(64 * wg, 64 * wg + 64)
        for a_base, a, a_name, b_base, b, b_name in (
                (sQ, q, "q", sK, k, "k"), (sdO, do, "do", sV, v, "v")):
            d, read = issue_abt(smem, sw128_desc(a_base + wg * 64 *
                                                 C["kRowBytes"]),
                                half_desc(m), 64, sw128_desc(b_base),
                                half_desc(n), n)
            np.testing.assert_array_equal(d, a[rows] @ b.T)
            assert read == [{(a_name, kk // 4), (b_name, kk // 4)}
                            for kk in range(8)]
    ds = _ints(rng, 64, n)
    dq, cols = issue_ab(smem, ds, sw128_desc(sK), half_desc(n))
    np.testing.assert_array_equal(dq, ds @ k)
    assert cols == {0: set(range(64)), 1: set(range(64, 128))}


def test_dq_shared_memory_at_head_dim_128_fits_one_block():
    """dq_smem_bytes<128>() as the source computes it: Q and dO (32 KB
    each), 4 stages of K and V (16 KB each), the 1024-byte alignment slack
    and the barriers, under the 227 KB a block may take; at D 64 it is the
    99,400 bytes the card reports."""
    body = re.search(r"constexpr int dq_smem_bytes\(\) \{\s*return ([^;]+);",
                     SRC).group(1)
    smem = {d: _cu_int_expr(body, {**C, "D": d}) for d in (64, 128)}
    assert smem == {64: 99400, 128: 197704}
    assert smem[128] <= 232448

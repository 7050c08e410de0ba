"""The p^T exchange of the f32 dk/dv at head dim 256
(flash_bwd_dkv_d256_tc_kernel of ray_tpu_torch/ops/csrc/flash_attention_f32.cu),
known without a card.

Warp w < 4 of the 256-thread block computes p^T of its 16 KV rows and
dv; warp w + 4, on the same rows, dp^T, ds^T and dk, and takes p^T from
warp w through shared memory. The address expressions and constants are
read from the source: each writer lane's values must land where the
reader lane takes them, at the same fragment position (KV row, Q
column), a warp's 32 accesses of one value must hit 32 banks, the pairs
must not overlap, and the kernel's shared memory must fit the 232,448
bytes a block may take.
"""
import re
from pathlib import Path

import pytest

from ray_tpu_torch.ops import flash_attention as tfa

# the f32 kernels' source: flash_attention_f32.cu after the shared 3xTF32
# helpers it includes (tf32_mma.cuh: the tile constants among them)
SRC = "".join((Path(tfa.__file__).resolve().parent / "csrc" / name).read_text()
              for name in ("tf32_mma.cuh", "flash_attention_f32.cu"))
KERNEL = SRC[SRC.index("flash_bwd_dkv_d256_tc_kernel(const float*"):]
KERNEL = KERNEL[:KERNEL.index("\n}\n")]
MAX_SMEM = 232448  # bytes of shared memory a block may take on an H100
BANKS = 32


def _int_expr(expr, env):
    return int(eval(" ".join(expr.split()).replace("/", "//"), {}, dict(env)))


def _const(name, env):
    m = re.search(rf"constexpr int {name} = ([^;]+);", SRC)
    assert m, name
    return _int_expr(m.group(1), env)


C = {}
for _name in ("kTile", "kTcWarps", "kTcThreads", "kDkv256Rows",
              "kDkv256Threads"):
    C[_name] = _const(_name, C)
BN = C["kDkv256Rows"]
NT = BN // 8

# this lane's base and the offset of value i = 4 n + e, as the kernel has them
SLOT = re.search(r"float\* x_slot = xp \+ ([^;]+);", KERNEL).group(1)
WRITE = re.search(r"x_slot\[([^\]]+)\] = pe;", KERNEL).group(1)
READ = re.search(r"x\[n\]\[e\] = x_slot\[([^\]]+)\]", KERNEL).group(1)


def _fragment(warp, lane, n, e):
    """(KV row of the block, Q column of the tile) of score value (n, e)
    of a lane: mma.sync's accumulator layout, rows wr + g + 8 (e / 2),
    columns 8 n + 2 t + e % 2, with wr the pair's 16 rows."""
    g, t = lane // 4, lane % 4
    wr = (warp % C["kTcWarps"]) * 16
    return wr + g + 8 * (e // 2), 8 * n + 2 * t + e % 2


def _addr(expr, warp, lane, n, e):
    env = dict(pair=warp % C["kTcWarps"], lane=lane, n=n, e=e, NT=NT)
    return _int_expr(SLOT, env) + _int_expr(expr, env)


def test_the_constants():
    assert C == {"kTile": 64, "kTcWarps": 4, "kTcThreads": 128,
                 "kDkv256Rows": 8, "kDkv256Threads": 256}
    assert SLOT == "pair * NT * 4 * 32 + lane"
    assert WRITE == READ == "32 * (4 * n + e)"


def test_each_value_lands_where_its_reader_takes_it():
    """Writer warp w and reader warp w + 4: every address written once,
    read once, by the lane of the same number, at the same (KV row, Q
    column); the four pairs' slots do not overlap and fill the buffer."""
    written, read = {}, {}
    for w in range(C["kTcWarps"]):
        for lane in range(32):
            for n in range(NT):
                for e in range(4):
                    a = _addr(WRITE, w, lane, n, e)
                    assert a not in written
                    written[a] = _fragment(w, lane, n, e)
                    b = _addr(READ, w + C["kTcWarps"], lane, n, e)
                    assert b not in read
                    read[b] = _fragment(w + C["kTcWarps"], lane, n, e)
    assert written == read
    assert sorted(written) == list(range(C["kTcWarps"] * 16 * BN))
    # each pair's values are its own 16 KV rows x BN Q columns, each once
    for w in range(C["kTcWarps"]):
        cells = {written[_addr(WRITE, w, lane, n, e)] for lane in range(32)
                 for n in range(NT) for e in range(4)}
        assert cells == {(16 * w + r, c) for r in range(16) for c in range(BN)}


@pytest.mark.parametrize("expr", [WRITE, READ], ids=["write", "read"])
def test_a_warp_access_hits_32_banks(expr):
    for warp in range(2 * C["kTcWarps"]):
        for n in range(NT):
            for e in range(4):
                banks = {_addr(expr, warp, lane, n, e) % BANKS
                         for lane in range(32)}
                assert len(banks) == 32


def test_a_pair_syncs_on_a_named_barrier_of_its_own():
    """The writer arrives and the reader waits on barrier 1 + pair for the
    pair's 64 threads: barrier 0 stays __syncthreads', and a pair that
    skips a tile under causal masking skips it in both warps."""
    assert "named_arrive(1 + pair, 64);" in KERNEL
    assert "named_sync(1 + pair, 64);" in KERNEL
    assert KERNEL.index("named_arrive") < KERNEL.index("accumulate<D, NT>(acc, x, sdo)")
    assert KERNEL.index("named_sync") < KERNEL.index("x_slot[32 * (4 * n + e)] *")
    skip = re.search(r"if \((causal && q0 \+ BN - 1 < k0 \+ wr)\) continue;",
                     KERNEL)
    assert skip and "wr = pair * 16" in KERNEL


def test_shared_memory_fits_one_block():
    """K and V (64 rows, 64 KB each), two stages of Q and dO (BN rows),
    their lse and delta, and the exchange fit one block; two blocks an SM
    would not, so one block of 8 warps takes the SM."""
    body = re.search(r"constexpr int dkv256_tc_smem_bytes\(\) \{\s*return "
                     r"([^;]+);", SRC).group(1)
    smem = _int_expr(body, C)
    exchange = C["kTcWarps"] * 16 * BN * 4
    assert smem == (2 * 64 + 2 * 2 * BN) * 256 * 4 + 2 * 2 * BN * 4 + exchange
    assert smem == 166016
    assert smem <= MAX_SMEM < 2 * smem
    assert "__launch_bounds__(kDkv256Threads, 1)" in SRC

"""The bf16 dq at head dim 256 (flash_bwd_dq_d256_kernel of
ray_tpu_torch/ops/csrc/flash_attention.cu), known without a card.

1. Its products through tests/test_torch_wgmma_layout.py's numpy model of
   shared memory, TMA's 128-byte swizzle and wgmma's descriptors, at the
   kernel's tile shapes and ring offsets, with its constants read from the
   source: s = q.k^T and dp = do.v^T over the four 64-column boxes of
   D 256, and dq += ds.k with the K stage read MN-major, one product a
   box.
2. Its two rings (two K stages, one V stage) as a model of mbarrier
   phases, driven by the order of the calls in the kernel's two loops as
   the source has them: under every interleaving tried of the two
   warpgroups, for causal and full masks and ragged S, no wait blocks
   forever, each tile is in its stage when a warpgroup waits for it, and
   no load lands in a stage that a warpgroup still holds.
"""
import random
import re

import numpy as np
import pytest

from tests.test_torch_wgmma_d256 import (D, MAX_SMEM, _const, issue_ab,
                                         issue_abt)
from tests.test_torch_wgmma_layout import (C, SRC, Smem, _ints, half_desc,
                                           sw128_desc)

K_STAGES, V_STAGES = _const("kDq256KStages"), _const("kDq256VStages")
KERNEL = SRC[SRC.index("flash_bwd_dq_d256_kernel(const __grid_constant__"):]
KERNEL = KERNEL[:KERNEL.index("\n}\n")]


# --------------------------------------------------------- 1. the products
def _dq_smem(rng, k_stage, v_stage):
    """Q and dO (128 rows), and a K and a V tile (64 rows) in the given
    stages, at the kernel's offsets: sQ, sdO, then kDq256KStages K stages,
    then kDq256VStages V stages."""
    m, n = C["kBlockM"], C["kDqBlockN"]
    tile = n * D * 2
    sQ = 1024
    sdO = sQ + m * D * 2
    sK = sdO + m * D * 2
    sV = sK + K_STAGES * tile
    x = dict(q=_ints(rng, m, D), do=_ints(rng, m, D), k=_ints(rng, n, D),
             v=_ints(rng, n, D))
    smem = Smem()
    base = dict(q=sQ, do=sdO, k=sK + k_stage * tile, v=sV + v_stage * tile)
    for name, b in base.items():
        smem.tma_tile(b, name, x[name])
    return smem, base, x


def test_the_ring_constants_and_offsets():
    assert (K_STAGES, V_STAGES) == (2, 1)
    assert C["kBlockM"] == 128 and C["kDqBlockN"] == 64
    for line in ("const uint32_t sdO = sQ + kQBytes;",
                 "const uint32_t sK = sdO + kQBytes;",
                 "const uint32_t sV = sK + kKS * kTileBytes;",
                 "const uint32_t bar_q = sV + kVS * kTileBytes;"):
        assert line in KERNEL, line
    m = 1024 + 2 * C["kBlockM"] * D * 2 + 3 * C["kDqBlockN"] * D * 2
    assert m + 7 * 8 == 230456 <= MAX_SMEM


@pytest.mark.parametrize("k_stage", range(2))
def test_dq_products_at_head_dim_256(k_stage):
    """Each warpgroup's 64 rows of the 128-row Q and dO tiles against the
    64-row K stage k_stage and the V stage: s = q.k^T and dp = do.v^T, 16
    k-steps with k-step kk in box kk / 4 of both operands; then dq += ds.k
    from the same K stage read MN-major, box h giving dq's columns 64h to
    64h + 63. All exact on small integers."""
    rng = np.random.default_rng(10 + k_stage)
    smem, base, x = _dq_smem(rng, k_stage, 0)
    m, n = C["kBlockM"], C["kDqBlockN"]
    for wg in (0, 1):
        rows = slice(64 * wg, 64 * wg + 64)
        for a, b in (("do", "v"), ("q", "k")):
            d, read = issue_abt(smem, sw128_desc(base[a] + wg * 64 *
                                                 C["kRowBytes"]),
                                half_desc(m), 64, sw128_desc(base[b]),
                                half_desc(n), n)
            np.testing.assert_array_equal(d, x[a][rows] @ x[b].T)
            assert read == [{(a, kk // 4), (b, kk // 4)} for kk in range(16)]
    ds = _ints(rng, 64, n)
    dq, cols = issue_ab(smem, ds, sw128_desc(base["k"]), half_desc(n), D)
    np.testing.assert_array_equal(dq, ds @ x["k"])
    assert cols == {h: set(range(64 * h, 64 * h + 64)) for h in range(4)}


def test_dp_is_issued_before_s_and_v_released_after_it():
    """V's single stage is released as soon as dp is done: dp is the first
    committed group, so wgmma_wait<1> waits for it alone."""
    loop = KERNEL[KERNEL.index("for (int it = 0; it < n_w; ++it)"):]
    order = [loop.index(s) for s in (
        "issue_abt<D>(dp, desc_do", "issue_abt<D>(sc, desc_q",
        "wgmma_wait<1>();", "release_v(it);", "wgmma_wait<0>();  // s",
        "pack_all(da, sc);", "issue_ab<D, kN>(acc, da, desc_k(it)",
        "release_k(it);")]
    assert order == sorted(order)


# ------------------------------------------------------- 2. the two rings
CALL = re.compile(r"\b(produce_k|produce_v|wait_k|wait_v|release_k|"
                  r"release_v)\((it|it \+ 1|0)\);")


def _calls(text):
    return [(name, arg) for name, arg in CALL.findall(text)]


def _program():
    """(prologue, main loop, skip loop): the ring calls in the kernel's
    order, each (name, argument)."""
    body = KERNEL[KERNEL.index("produce_k(0);"):]
    main = body.index("for (int it = 0; it < n_w; ++it)")
    skip = body.index("for (int it = n_w; it < n_kv; ++it)")
    return _calls(body[:main]), _calls(body[main:skip]), _calls(body[skip:])


def test_the_program_is_what_the_model_runs():
    prologue, main, skip = _program()
    assert prologue == [("produce_k", "0"), ("produce_v", "0")]
    assert main == [("produce_k", "it + 1"), ("wait_k", "it"),
                    ("wait_v", "it"), ("release_v", "it"),
                    ("produce_v", "it + 1"), ("release_k", "it")]
    assert skip == main


class _Bar:
    """An mbarrier: completed phases, and arrivals toward the next."""

    def __init__(self, count):
        self.count, self.phase, self.arrived = count, 0, 0

    def done(self, parity):
        return (self.phase & 1) != parity

    def arrive(self, n=1):
        self.arrived += n
        assert self.arrived <= self.count
        if self.arrived == self.count:
            self.phase, self.arrived = self.phase + 1, 0


def _run(S, q_tile, causal, seed):
    """The two warpgroups of one block, interleaved at random; thread 0
    (warpgroup 0) issues the loads. Fails on a deadlock or a wrong tile."""
    kN, kM = C["kDqBlockN"], C["kBlockM"]
    q0 = q_tile * kM
    n_kv = -(-(min(q0 + kM, S) if causal else S) // kN)
    rings = {"k": K_STAGES, "v": V_STAGES}
    full = {r: [_Bar(1) for _ in range(n)] for r, n in rings.items()}
    empty = {r: [_Bar(8) for _ in range(n)] for r, n in rings.items()}
    held = {r: [set() for _ in range(n)] for r, n in rings.items()}
    tile_in = {r: [None] * n for r, n in rings.items()}
    prologue, main, skip = _program()

    def agent(wg):
        wg_row0 = q0 + 64 * wg
        n_w = -(-min(wg_row0 + 64, S) // kN) if causal else n_kv
        ops = [(name, 0 if arg == "0" else None) for name, arg in prologue]
        for it in range(n_kv):
            for name, arg in (main if it < n_w else skip):
                ops.append((name, it + (arg == "it + 1")))
        for name, j in ops:
            kind, ring = name.split("_")
            stages = rings[ring]
            s = j % stages
            if kind == "produce":
                if wg != 0 or j >= n_kv:
                    continue
                while not empty[ring][s].done(((j // stages) & 1) ^ 1):
                    yield False  # blocked
                assert not held[ring][s], (ring, j, held[ring][s])
                tile_in[ring][s] = j
                full[ring][s].arrive()  # the TMA bytes land
            elif kind == "wait":
                while not full[ring][s].done((j // stages) & 1):
                    yield False
                assert tile_in[ring][s] == j, (ring, j, tile_in[ring][s])
                held[ring][s].add(wg)
            else:
                held[ring][s].discard(wg)
                empty[ring][s].arrive(4)  # the warpgroup's four warps
            yield True

    rng = random.Random(seed)
    agents = [agent(0), agent(1)]
    live, blocked = [0, 1], 0
    while live:
        wg = rng.choice(live)
        try:
            blocked = 0 if next(agents[wg]) else blocked + 1
        except StopIteration:
            live.remove(wg)
            blocked = 0
        assert blocked < 1000, f"deadlock at S={S} tile {q_tile}"


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 200, 256, 1000])
def test_the_rings_never_deadlock_or_mix_tiles(S, causal):
    for q_tile in range(-(-S // C["kBlockM"])):
        for seed in range(8):
            _run(S, q_tile, causal, seed)

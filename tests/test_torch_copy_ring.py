"""The copy ceiling's bulk-copy ring (``copy_rows_ring_kernel`` in
``csrc/sweep_kernels.cu``), emulated in numpy step by step.

The kernel is one warp a block that walks its items (a span of tile_n
columns a turn, in stage chunks of W columns, in row blocks of kb rows):
it arms a stage's mbarrier and issues one bulk load a row, waits on the
stage's phase parity, issues one bulk store a row of rows 0..r-1 as one
committed group, and refills the stage before it once ``wait_group.read
1`` has let that stage's stores read it.  The lanes split each stage's
rows and each waits on its own store groups before a ``__syncwarp``, so
the warp moves as the one thread emulated here.  The emulation follows
those steps (test code, not a second path of the port) with the source's
constants, and checks what the card would only show as a hang or a wrong
byte:

- every wait is on the phase that the stage's newest load completes (a
  wrong parity waits forever or passes on stale bytes);
- no load lands in a stage that a pending store group still reads;
- every bulk copy is 16-byte aligned in address and size, and every
  stage fits its stride, the ring the card's shared memory;
- every byte of the k rows is loaded once and every byte of rows 0..r-1
  stored once, so the output is ``data[:r]``, as the JAX package's
  ``_copy_kernel`` gives it.

The emulation is a hand copy of ``launch_copy_ring``'s geometry (the
stage row W, the rows a stage holds, the stride) and of the kernel's
schedule (first fills, phase wait, stores, refill of the stage before,
phase flip), and must be kept in step with them:
``test_emulation_mirrors_the_source`` holds the C statements it copies
verbatim, so that a change to one of them fails here until the emulation
follows.  The bitwise check of the kernel itself is ``chip_smoke.py``'s
``copy_rows_grid``, on the card.

Inputs come from ``np.random.default_rng(seed)``; bytes, tolerance 0.
"""
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from ceph_tpu_torch.ops import cuda_build
from tools import kernel_sweep as jks

SOURCE = os.path.join(cuda_build.CSRC, "sweep_kernels.cu")
SMEM_OPTIN = 232448        # H100: the most dynamic shared memory a block
TX_MAX = (1 << 20) - 1     # an mbarrier's transaction count


def _constant(name: str) -> int:
    with open(SOURCE) as f:
        m = re.search(rf"constexpr int {name} = ([0-9 *]+);", f.read())
    return eval(m.group(1))           # noqa: S307 - "32 * 1024" and such


STAGES = _constant("COPY_STAGES")
STAGE_BYTES = _constant("COPY_STAGE_BYTES")
W_MIN = _constant("COPY_W_MIN")
ALIGN = _constant("COPY_ALIGN")


def _up(x: int, a: int) -> int:
    return -(-x // a) * a


def geometry(k, n, tile_n):
    """launch_copy_ring's plan and shared memory bytes."""
    w = max(W_MIN, STAGE_BYTES // k // 16 * 16)
    w = min(w, tile_n)
    kb = min(k, STAGE_BYTES // w)
    stride = _up(kb * w, ALIGN)
    return {"n": n, "tile_n": tile_n, "spans": -(-n // tile_n), "k": k,
            "w": w, "kb": kb, "stride": stride,
            "bars": _up(8 * STAGES, ALIGN),
            "smem": _up(8 * STAGES, ALIGN) + STAGES * stride}


def cursor_items(p, b, grid):
    """CopyCursor's walk from block b: (c0, w, j0, rows), by additions."""
    n, tile, w, kb, k = p["n"], p["tile_n"], p["w"], p["kb"], p["k"]
    span, j0 = b, 0
    c0 = span * tile
    end = min(n, c0 + tile)
    while span < p["spans"]:
        yield c0, min(w, end - c0), j0, min(kb, k - j0)
        j0 += kb
        if j0 < k:
            continue
        j0, c0 = 0, c0 + w
        if c0 < end:
            continue
        span += grid
        c0 = span * tile
        end = min(n, c0 + tile)


def closed_form_items(p, b, grid):
    """The same items by division: turn, chunk of the span, row block."""
    rowblocks, cps = -(-p["k"] // p["kb"]), -(-p["tile_n"] // p["w"])
    turns = (p["spans"] - b + grid - 1) // grid
    last_cols = min(p["tile_n"], p["n"] - (b + (turns - 1) * grid)
                    * p["tile_n"])
    total = ((turns - 1) * cps + -(-last_cols // p["w"])) * rowblocks
    out = []
    for t in range(total):
        q = t // rowblocks
        span = b + (q // cps) * grid
        c0 = span * p["tile_n"] + (q % cps) * p["w"]
        end = min(p["n"], (span + 1) * p["tile_n"])
        j0 = (t % rowblocks) * p["kb"]
        out.append((c0, min(p["w"], end - c0), j0, min(p["kb"], p["k"] - j0)))
    return out


def run_ring(data, r, tile_n, grid):
    """The kernel over ``data`` [k, n] with ``grid`` blocks: (out, counts
    of loads per data byte, of stores per out byte)."""
    k, n = data.shape
    stages = STAGES
    p = geometry(k, n, tile_n)
    grid = min(grid, p["spans"])
    out = np.zeros((r, n), np.uint8)
    loaded = np.zeros((k, n), np.int64)
    stored = np.zeros((r, n), np.int64)
    for b in range(grid):
        items = list(cursor_items(p, b, grid))
        assert items == closed_form_items(p, b, grid)
        smem = np.zeros(p["smem"], np.uint8)
        issued = [0] * stages             # loads armed on each barrier
        holds = [None] * stages           # the item a stage was loaded with
        groups = []                       # pending store groups: stages read
        nxt = [0]                         # the loader's item

        def load(s):
            t = nxt[0]
            c0, w, j0, rows = items[t]
            assert s == t % stages, f"item {t} loaded into stage {s}"
            assert all(s not in g for g in groups), \
                f"load {t} lands in stage {s} while a store still reads it"
            assert 0 < rows * w <= TX_MAX and w % 16 == 0 and c0 % 16 == 0
            dst = p["bars"] + s * p["stride"]
            for j in range(rows):
                assert (dst + j * p["w"]) % 16 == 0
                smem[dst + j * p["w"]:dst + j * p["w"] + w] = \
                    data[j0 + j, c0:c0 + w]
                loaded[j0 + j, c0:c0 + w] += 1
            issued[s] += 1
            holds[s] = t
            nxt[0] += 1

        for s in range(stages):
            if nxt[0] < len(items):
                load(s)
        s, prev, phase = 0, -1, 0
        for t in range(len(items)):
            # try_wait.parity passes once the phase of that parity is done;
            # all issued loads complete, so the barrier ends at phase
            # issued[s]: the wait must be on the newest of them
            assert issued[s] % 2 != phase and issued[s] == t // stages + 1, \
                f"block {b} item {t}: stage {s} waits on a stale phase"
            assert holds[s] == t
            c0, w, j0, rows = items[t]
            src = p["bars"] + s * p["stride"]
            for j in range(max(0, min(rows, r - j0))):
                out[j0 + j, c0:c0 + w] = \
                    smem[src + j * p["w"]:src + j * p["w"] + w]
                stored[j0 + j, c0:c0 + w] += 1
            groups.append({s})
            if prev >= 0 and nxt[0] < len(items):
                del groups[:-1]           # wait_group.read 1
                load(prev)
            prev = s
            s += 1
            if s == stages:
                s, phase = 0, phase ^ 1
        del groups[:]                     # wait_group.read 0
    return out, loaded, stored


CASES = [
    (4, 8, 8192 * 5, 8192, 2),          # whole spans, several turns
    (4, 8, 8192 * 5 + 48, 8192, 3),     # a short last span, 16 | n
    (4, 8, 65536, 32768, 132),          # grid cut to the spans
    (8, 8, 4096, 256, 3),               # r = k, W capped by tile_n
    (1, 8, 20000, 512, 4),              # r = 1
    (16, 64, 4096 + 1024, 256, 5),      # the xor_apply yardsticks' k
    (64, 128, 8192, 8192, 2),
    (3, 5, 40000, 256, 7),              # W a multiple of 16, not of 256
    (2500, 3000, 256, 256, 1),          # row blocks: k * 16 > a stage
    (1, 3000, 512, 256, 2),             # a row block with no stored row
    (4, 8, 50000, 8192, 3),             # a short last chunk in a span
    (2, 2, 16, 256, 1),                 # one 16-byte column chunk
    (12, 12, 8192 * 3 + 2720, 8192, 2), # W = 2720: chunks across spans
    (5, 200, 4096, 4096, 2),            # 13 row blocks, the last short
]


@pytest.mark.parametrize("r,k,n,tile,grid", CASES)
def test_ring_copies_every_row_once(r, k, n, tile, grid):
    data = np.random.default_rng(r * 7 + k + n).integers(
        0, 256, size=(k, n), dtype=np.uint8)
    out, loaded, stored = run_ring(data, r, tile, grid)
    assert np.array_equal(out, data[:r])
    assert (loaded == 1).all() and (stored == 1).all()


@pytest.mark.parametrize("k", [1, 2, 3, 8, 20, 64, 127, 128, 200, 2048,
                               2049, 5000, 100000])
def test_geometry_fits_the_card_at_every_k(k):
    """Every k the wrapper takes launches: a stage holds at most
    COPY_STAGE_BYTES, its rows start 16-byte aligned, and the ring fits one
    block's shared memory."""
    for tile in (256, 8192, 32768):
        p = geometry(k, 1 << 20, tile)
        assert p["w"] % 16 == 0 and 16 <= p["w"] <= tile
        assert p["kb"] * p["w"] <= STAGE_BYTES and p["kb"] >= 1
        assert p["stride"] % ALIGN == 0 and p["smem"] <= SMEM_OPTIN
        assert p["kb"] * p["w"] <= TX_MAX


@pytest.mark.parametrize("k,w,kb", [(8, 4096, 8), (12, 2720, 12),
                                    (16, 2048, 16), (64, 2048, 16),
                                    (128, 2048, 16)])
def test_stage_width_follows_k(k, w, kb):
    """About 32 KiB a stage: all k rows of 32 KiB / k bytes up to 4 KiB;
    where that is under 2 KiB (a bulk copy of a few hundred bytes costs
    the copy unit about what one of 2 KiB does), row blocks of 16 rows of
    2 KiB."""
    p = geometry(k, 8 << 20, 8192)
    assert (p["w"], p["kb"]) == (w, kb)
    assert 32768 - 16 * kb < p["kb"] * p["w"] <= 32768


def test_ring_matches_copy_kernel_interpret():
    r, k, n, tile = 4, 8, 2048, 512
    data = np.random.default_rng(19).integers(0, 256, size=(k, n),
                                              dtype=np.uint8)
    want = np.asarray(pl.pallas_call(
        functools.partial(jks._copy_kernel, r=r, k=k),
        out_shape=jax.ShapeDtypeStruct((r, n), jnp.uint8),
        grid=(n // tile,),
        in_specs=[pl.BlockSpec((k, tile), lambda i: (0, i))],
        out_specs=pl.BlockSpec((r, tile), lambda i: (0, i)),
        interpret=True)(jnp.asarray(data)))
    assert np.array_equal(run_ring(data, r, tile, 3)[0], want)


def test_launch_signatures_match_the_source():
    """copy_rows_launch lines up with cuda_build.SIGNATURES, so each ctypes
    argument has its width, and it is the copy's only C entry."""
    with open(SOURCE) as f:
        src = f.read()
    params = [q.strip() for q in re.search(
        r"int copy_rows_launch\(([^)]*)\)", src).group(1).split(",")]
    argtypes = cuda_build.SIGNATURES["sweep_kernels"]["copy_rows_launch"]
    assert len(params) == len(argtypes) == 7
    for q, a in zip(params, argtypes):
        if "*" in q:
            assert a is cuda_build._P, q
        elif q.startswith("long long"):
            assert a is cuda_build._L, q
        else:
            assert q.startswith("int ") and a is cuda_build._I, q
    assert sorted(e for e in cuda_build.SIGNATURES["sweep_kernels"]
                  if e.startswith("copy_rows")) == ["copy_rows_launch"]


# the C statements that geometry() and run_ring() copy by hand
MIRRORED = [
    # launch_copy_ring: the stage row, the rows a stage holds, the stride
    "long long w = (long long)(COPY_STAGE_BYTES / k) / 16 * 16;",
    "w = w < COPY_W_MIN ? COPY_W_MIN : w;",
    "p.w = (int)(w < tile_n ? w : tile_n);",
    "p.kb = COPY_STAGE_BYTES / p.w < k ? COPY_STAGE_BYTES / p.w : k;",
    "p.stride = (p.kb * p.w + COPY_ALIGN - 1) / COPY_ALIGN * COPY_ALIGN;",
    "const size_t smem = (size_t)COPY_BARS + (size_t)COPY_STAGES * p.stride;",
    # copy_rows_ring_kernel: first fills, phase wait, stores, refill, flip
    "for (int s = 0; s < COPY_STAGES && ld.valid(p); ++s) load(s);",
    "for (int s = 0, prev = -1, phase = 0; st.valid(p);) {",
    "while (!mbar_try_wait(bars + 8 * s, (uint32_t)phase)) {",
    "const int w = st.width(p), stored = min(st.rows(p), p.r - st.j0);",
    "if (prev >= 0 && ld.valid(p)) { bulk_wait_read<1>(); __syncwarp(); "
    "load(prev); }",
    "prev = s;",
    "if (++s == COPY_STAGES) s = 0, phase ^= 1;",
    # CopyCursor: the walk cursor_items() copies
    "if ((j0 += p.kb) < p.k) return;",
    "if ((c0 += p.w) < end) return;",
    "span += gridDim.x;",
]


@pytest.mark.parametrize("statement", MIRRORED)
def test_emulation_mirrors_the_source(statement):
    """Each statement the emulation copies stands in the source as it was
    copied (whitespace aside): a change to the kernel or its launcher
    fails here until geometry() and run_ring() follow it."""
    with open(SOURCE) as f:
        src = " ".join(f.read().split())
    assert " ".join(statement.split()) in src

"""Device-mesh sharding of codec batches and placement seeds.

The port of ``ceph_tpu.parallel.mesh``.  The reference shards a stripe
batch over a ``jax.sharding.Mesh`` and lets XLA insert the collectives
(the analog of the primary OSD fanning ECSubWrites out to its shards,
reference: src/osd/ECBackend.cc:2036-2070).  The port keeps the single
controller: one process holds a [dp, sp] grid of ``torch.device``s
(:class:`Mesh`), every step runs each shard's local work on that shard's
device, and the collectives are moves between devices:

  dp   data parallel over stripes (the decode: over survivor chunks; the
       placement: over seeds)
  sp   parallel over chunk bytes

- ``psum`` over an axis: the partials of the shards that differ only on
  that axis move to the first one's device, are reduced there (a sum, or
  an XOR for GF(2^8) partials), and the result moves back to each of them;
- ``ppermute`` around the dp ring: shard (i, j)'s block moves to the
  device of shard ((i + 1) % dp, j).

A move is ``tensor.to(device, non_blocking=True)``.  Between two cards it
is a peer copy, which PyTorch issues on the source card's current stream
after an event barrier with the destination card's current stream, and
orders the destination stream after the copy with another event; so a
read on one card of a tensor another card made is ordered after the
write.  On one device a move is the tensor itself.  Every shard's work
runs on its device's current stream; a caller that runs the work on
streams of its own (``ops/pipeline.py``) makes them current on every card
of the mesh.

A mesh may name one device more than once: ``make_mesh(8, devices=["cpu"]
* 8)`` is the counterpart of the 8 XLA host devices the JAX tests force,
and ``[cuda:0] * 4`` a 4-shard mesh on one card.

A step's outputs are :class:`Sharded`: the blocks on their shards'
devices, as a sharded ``jax.Array`` holds them; ``.full()`` gathers one
tensor and ``numpy.asarray`` one host array.  A step takes numpy or a
tensor and splits it itself, or a :class:`Sharded` that :func:`shard`
made (zero-padded to a global shape that divides, as the reference's
callers pad with ``jnp.pad``): the codec pipeline serves its mesh
batches that way, moving each block on its own streams and bringing the
results back with ``Sharded.host``.

The kernels are the single card's.  Both encode steps run
``rs_kernels.gf_apply_stripes`` (``ops/csrc/gf_apply.cu``) on each shard,
the decode step ``rs_kernels.gf_apply`` (where the reference runs its XLA
``gf_apply_lookup``), and the placement step ``BulkMapper.map_rule``
(``ops/csrc/crush_straw2.cu``) once a dp row, where the reference repeats
it on every sp shard with equal results.  On CPU devices each runs its
plain PyTorch version.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import rs_kernels

CRUSH_ITEM_NONE = 0x7FFFFFFF


class Mesh:
    """A [dp, sp] grid of devices of one type.  ``shape`` is
    ``{"dp": dp, "sp": sp}``, as a JAX ``Mesh.shape`` is."""

    def __init__(self, grid):
        self.grid = tuple(tuple(torch.device(d) for d in row)
                          for row in grid)
        dp = len(self.grid)
        sp = len(self.grid[0]) if dp else 0
        if not sp or any(len(row) != sp for row in self.grid):
            raise ValueError("a mesh is a non-empty [dp, sp] grid")
        types = {d.type for row in self.grid for d in row}
        if len(types) != 1:
            raise ValueError(f"a mesh holds devices of one type, not "
                             f"{sorted(types)}")
        self.shape = {"dp": dp, "sp": sp}
        self.device_type = types.pop()

    def device(self, i: int, j: int) -> torch.device:
        return self.grid[i][j]

    def shards(self) -> list[tuple[int, int]]:
        return [(i, j) for i in range(self.shape["dp"])
                for j in range(self.shape["sp"])]

    @property
    def devices(self) -> list[torch.device]:
        """The distinct devices, in grid order."""
        return list(dict.fromkeys(d for row in self.grid for d in row))

    def groups(self, axis: str) -> list[list[tuple[int, int]]]:
        """The shards that differ only on ``axis``, one list a group."""
        if axis == "sp":
            return [[(i, j) for j in range(self.shape["sp"])]
                    for i in range(self.shape["dp"])]
        return [[(i, j) for i in range(self.shape["dp"])]
                for j in range(self.shape["sp"])]


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              devices=None) -> Mesh:
    """A (dp, sp) mesh over the first ``n_devices`` of ``devices`` (by
    default every card: cuda:0 .. cuda:{device_count - 1}).  ``dp``
    defaults to the largest divisor of n that is at most sqrt(n)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(
            f"mesh wants {n} devices, only {len(devices)} present")
    if n < 1:
        raise ValueError("a mesh needs at least one device")
    if dp is None:
        dp = next(c for c in range(math.isqrt(n), 0, -1) if n % c == 0)
    if dp < 1 or n % dp:
        raise ValueError(f"dp={dp} does not divide {n} devices")
    sp = n // dp
    return Mesh([devices[i * sp:(i + 1) * sp] for i in range(dp)])


def _block_index(mesh: Mesh, shape: tuple, spec: tuple, i: int,
                 j: int) -> tuple:
    """Shard (i, j)'s slices of a global array of ``shape`` split by
    ``spec`` (per dimension: "dp", "sp" or None)."""
    idx = []
    for size, axis in zip(shape, spec):
        if axis is None:
            idx.append(slice(0, size))
        else:
            parts = mesh.shape[axis]
            pos = i if axis == "dp" else j
            step = size // parts
            idx.append(slice(pos * step, (pos + 1) * step))
    return tuple(idx)


def _clip(idx: tuple, shape) -> tuple:
    """The slices ``idx`` cut to an array of ``shape``."""
    return tuple(slice(min(s.start, n), min(s.stop, n))
                 for s, n in zip(idx, shape))


def _lead(shape) -> tuple:
    """The slices of the leading ``shape`` corner of a larger array."""
    return tuple(slice(0, n) for n in shape)


class Sharded:
    """A global array held as blocks on a mesh's shards: the counterpart
    of a ``jax.Array`` sharded by a ``PartitionSpec``.  ``spec`` names, for
    each dimension, the mesh axis it is split over ("dp" or "sp") or None
    (whole); ``blocks[(i, j)]`` is shard (i, j)'s block, on its device.
    Along an axis that splits no dimension the blocks are replicas."""

    def __init__(self, mesh: Mesh, shape, spec, blocks: dict):
        self.mesh = mesh
        self.shape = tuple(int(s) for s in shape)
        self.spec = tuple(spec)
        self.blocks = blocks

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[(0, 0)].dtype

    def owners(self) -> list[tuple[int, int]]:
        """The shards whose blocks make up the array once (one replica of
        each distinct block)."""
        rows = range(self.mesh.shape["dp"]) if "dp" in self.spec else (0,)
        cols = range(self.mesh.shape["sp"]) if "sp" in self.spec else (0,)
        return [(i, j) for i in rows for j in cols]

    @property
    def nbytes(self) -> int:
        """The bytes of the distinct blocks."""
        return sum(int(self.blocks[ij].nbytes) for ij in self.owners())

    def full(self, device=None, out: torch.Tensor | None = None
             ) -> torch.Tensor:
        """The global array as one tensor on ``device`` (default: the
        first shard's device), or written into ``out``, which may be
        shorter than the array on any dimension: the zero padding a
        caller added before it sharded is then dropped."""
        if out is None:
            dev = self.mesh.device(0, 0) if device is None \
                else torch.device(device)
            out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for ij in self.owners():
            idx = _clip(_block_index(self.mesh, self.shape, self.spec, *ij),
                        out.shape)
            out[idx].copy_(self.blocks[ij][_lead(
                s.stop - s.start for s in idx)], non_blocking=out.is_cuda)
        return out

    def host(self) -> Sharded:
        """The distinct blocks moved into one host buffer (pinned when the
        mesh holds cards), each move ``non_blocking`` on its device's
        current stream: the result's :meth:`full` is the global array once
        the moves are done."""
        owners = self.owners()
        buf = torch.empty(sum(self.blocks[ij].numel() for ij in owners),
                          dtype=self.dtype,
                          pin_memory=self.mesh.device_type == "cuda")
        blocks, at = {}, 0
        for ij in owners:
            blk = self.blocks[ij]
            blocks[ij] = buf[at:at + blk.numel()].view(blk.shape)
            blocks[ij].copy_(blk, non_blocking=True)
            at += blk.numel()
        return Sharded(self.mesh, self.shape, self.spec, blocks)

    def __array__(self, dtype=None, copy=None):
        out = self.full("cpu").numpy()
        return out if dtype is None else out.astype(dtype)


def _u8(x) -> torch.Tensor:
    """A numpy array becomes a CPU tensor; a tensor must be uint8."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.uint8:
            raise TypeError(f"expected uint8, got {x.dtype}")
        return x
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8))


def shard(mesh: Mesh, x, spec: tuple, shape=None) -> Sharded:
    """``x`` (uint8, numpy or a tensor) split over the mesh by ``spec``:
    each shard's block, contiguous on its device, as ``jax.device_put``
    with a ``NamedSharding`` places an array.  ``shape`` (default x's) is
    the global shape, at least x's on every dimension: past x's extent
    the blocks hold zeros, as the reference pads (``jnp.pad``) before it
    shards.  An axis that does not divide its dimension of ``shape``
    raises ValueError, as ``shard_map`` refuses the shape.

    Every move is ``non_blocking`` on the destination's current stream.
    A host block bound for a card that is not one contiguous run of
    pinned memory (a strided window of a larger array, or a padded one)
    is first gathered on the host into pinned memory, so that its move
    is asynchronous too."""
    x = _u8(x)
    shape = tuple(x.shape) if shape is None else tuple(int(s) for s in shape)
    if x.dim() != len(spec) or len(shape) != len(spec):
        raise ValueError(f"expected {len(spec)}-D, got {tuple(x.shape)}")
    for size, have, axis in zip(shape, x.shape, spec):
        if size < have:
            raise ValueError(f"global shape {shape} is smaller than "
                             f"{tuple(x.shape)}")
        if axis is not None and size % mesh.shape[axis]:
            raise ValueError(f"a dimension of {size} does not split over "
                             f"{axis}={mesh.shape[axis]}")
    blocks = {}
    for ij in mesh.shards():
        dev = mesh.device(*ij)
        idx = _block_index(mesh, shape, spec, *ij)
        part = x[_clip(idx, x.shape)]
        whole = all(s.stop - s.start == n for s, n in zip(idx, part.shape))
        host_to_card = part.device.type == "cpu" and dev.type == "cuda"
        if whole and not (host_to_card and not (part.is_contiguous()
                                                and part.is_pinned())):
            blocks[ij] = part.to(dev, non_blocking=True).contiguous()
            continue
        home = torch.device("cpu") if host_to_card else dev
        blk = (torch.empty if whole else torch.zeros)(
            tuple(s.stop - s.start for s in idx), dtype=x.dtype,
            device=home, pin_memory=host_to_card)
        blk[_lead(part.shape)].copy_(part, non_blocking=True)
        blocks[ij] = blk.to(dev, non_blocking=True)
    return Sharded(mesh, shape, spec, blocks)


def _scatter(mesh: Mesh, x, spec: tuple, shape=None) -> dict:
    """Each shard's block of ``x``: a :class:`Sharded` of ``spec`` (and of
    ``shape``, when given) as it is, else :func:`shard` of it."""
    if not isinstance(x, Sharded):
        return shard(mesh, x, spec, shape).blocks
    if x.mesh is not mesh or x.spec != tuple(spec) or \
            (shape is not None and x.shape != tuple(shape)):
        raise ValueError(f"a {x.shape} array split {x.spec} where "
                         f"{shape} split {tuple(spec)} is wanted")
    return {ij: x.blocks[ij].to(mesh.device(*ij), non_blocking=True)
            for ij in mesh.shards()}


def _psum(mesh: Mesh, parts: dict, axis: str, op=torch.add) -> dict:
    """All-reduce of ``parts`` (a tensor a shard) over ``axis`` with
    ``op``: each group reduces on its first shard's device and the result
    moves back to every shard of the group.  A group whose first shard has
    no part is skipped."""
    out = {}
    for group in mesh.groups(axis):
        if group[0] not in parts:
            continue
        home = mesh.device(*group[0])
        acc = parts[group[0]]
        for ij in group[1:]:
            acc = op(acc, parts[ij].to(home, non_blocking=True))
        for ij in group:
            out[ij] = acc.to(mesh.device(*ij), non_blocking=True)
    return out


def _replicas(mat: np.ndarray, mesh: Mesh) -> dict:
    """``mat`` uploaded once to each device of the mesh.  The uploads are
    waited for, so that a step built on one stream may run on another."""
    host = torch.from_numpy(np.ascontiguousarray(mat, dtype=np.uint8))
    mats = {dev: host.to(dev) for dev in mesh.devices}
    for dev in mats:
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
    return mats


def _encode_shards(mesh: Mesh, mats: dict, data) -> tuple[dict, tuple]:
    """Every shard's parity block: its [B/dp, k, N/sp] data block,
    restacked to the vertical layout [B/dp * k, N/sp], through
    ``gf_apply_stripes`` on its device."""
    if not isinstance(data, Sharded):
        data = _u8(data)
    blocks = _scatter(mesh, data, ("dp", None, "sp"))
    m = mats[mesh.device(0, 0)].shape[0]
    parity = {}
    for ij, blk in blocks.items():
        b, k, n = blk.shape
        parity[ij] = rs_kernels.gf_apply_stripes(
            mats[mesh.device(*ij)], blk.reshape(b * k, n), b).reshape(
                b, m, n)
    return parity, (data.shape[0], m, data.shape[2])


def sharded_encode_step(mesh: Mesh, parity_mat: np.ndarray):
    """The multi-device encode step.  Returns ``step(data)``, data [B, k,
    N] uint8 (numpy, a tensor, or a :class:`Sharded` of it from
    :func:`shard`), split [B@dp, k, N@sp] -> (parity [B, m,
    N] split the same way, checksum [B] int64 summed over sp, rotated:
    the parity moved one step around the dp ring), each :class:`Sharded`.

    The checksum sums every parity byte of a stripe, as the reference's
    ``parity.astype(int32).sum(axis=(1, 2))`` does under ``jax_enable_x64``
    (which its CRUSH kernel needs, and its tests and dry run turn on): an
    int64 that does not wrap.  ``B % dp`` or ``N % sp`` not 0 raises."""
    mats = _replicas(parity_mat, mesh)
    spec = ("dp", None, "sp")

    def step(data):
        parity, shape = _encode_shards(mesh, mats, data)
        # placement checksum, the deep-scrub cross-check per shard
        # (reference: src/osd/ECBackend.cc:2461), summed over sp
        local = {ij: p.sum(dim=(1, 2), dtype=torch.int64)
                 for ij, p in parity.items()}
        # sub-write fan-out: each shard's parity to its dp-ring neighbour
        dp = mesh.shape["dp"]
        rotated = {((i + 1) % dp, j): p.to(mesh.device((i + 1) % dp, j),
                                           non_blocking=True)
                   for (i, j), p in parity.items()}
        return (Sharded(mesh, shape, spec, parity),
                Sharded(mesh, shape[:1], ("dp",), _psum(mesh, local, "sp")),
                Sharded(mesh, shape, spec, rotated))
    return step


def sharded_batch_encode_step(mesh: Mesh, parity_mat: np.ndarray):
    """Parity-only multi-device encode: :func:`sharded_encode_step`'s
    sharding and kernel with no checksum and no rotation.  Returns
    ``step(data [B, k, N])`` -> parity [B, m, N] (:class:`Sharded`)."""
    mats = _replicas(parity_mat, mesh)

    def step(data):
        parity, shape = _encode_shards(mesh, mats, data)
        return Sharded(mesh, shape, ("dp", None, "sp"), parity)
    return step


def sharded_decode_step(mesh: Mesh):
    """Distributed reconstruction: survivors split over dp, partial
    GF(2^8) products XOR-reduced over dp.

    The reference rebuilds a lost shard by pulling chunks from helper OSDs
    and combining them on the primary (src/osd/ECBackend.cc:565-732).
    Here survivor chunks split [n@dp, N@sp]; each shard applies its
    columns of the decode matrix to its chunks (a partial product) and the
    partials XOR over dp, which is GF(2^8) addition.  The reference sums
    bit planes mod 2 in its ``psum``; XOR gives the same bytes.

    Returns ``step(D [r, n] uint8, chunks [n, N] uint8)`` -> [r, N]
    (:class:`Sharded`, split [r, N@sp], whole on every dp row).  A survivor
    count that does not divide over dp is zero-padded.  Either input may
    be a :class:`Sharded` already split (``D`` [None, n@dp], ``chunks``
    [n@dp, N@sp]) and padded: a caller's device-resident decode matrix,
    or survivors :func:`shard` moved."""
    ndp = mesh.shape["dp"]

    def step(D, chunks):
        D = D if isinstance(D, Sharded) else _u8(D)
        chunks = chunks if isinstance(chunks, Sharded) else _u8(chunks)
        n = chunks.shape[0]
        if len(D.shape) != 2 or D.shape[1] != n:
            raise ValueError(
                f"D has {D.shape[-1]} columns for {n} survivor chunks")
        n += (-n) % ndp
        r, N = D.shape[0], chunks.shape[1]
        Ds = _scatter(mesh, D, (None, "dp"), (r, n))
        cs = _scatter(mesh, chunks, ("dp", "sp"), (n, N))
        partial = {ij: rs_kernels.gf_apply(Ds[ij], cs[ij])
                   for ij in mesh.shards()}
        return Sharded(mesh, (r, N), (None, "sp"),
                       _psum(mesh, partial, "dp", torch.bitwise_xor))
    return step


def _histogram(out: torch.Tensor, n_osds: int) -> torch.Tensor:
    """Valid placements per OSD id, [n_osds] int32.  Holes
    (CRUSH_ITEM_NONE) and negatives are masked; an id of n_osds or more
    is dropped, as JAX's ``.at[].add`` drops an out-of-range index."""
    valid = (out >= 0) & (out != CRUSH_ITEM_NONE) & (out < n_osds)
    idx = torch.where(valid, out, 0).to(torch.int64).flatten()
    hist = torch.zeros(n_osds, dtype=torch.int64, device=out.device)
    hist.scatter_add_(0, idx, valid.to(torch.int64).flatten())
    return hist.to(torch.int32)


def sharded_placement_step(mesh: Mesh, bulk, ruleno: int, n_osds: int,
                           reweights=None, result_max: int = 0):
    """Distributed bulk placement: the multi-device ParallelPGMapper
    (reference: src/osd/OSDMapMapping.h:18).  The placement seeds split
    over dp; each dp row maps its block with ``bulk.map_rule`` on its
    first shard's device, and the per-OSD histogram of valid placements is
    summed over dp.  Returns ``step(xs [N])`` -> (out [N, numrep] int32
    split [N@dp, numrep], hist [n_osds] int32 on every shard), each
    :class:`Sharded`.  ``N % dp`` not 0 raises."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]

    def step(xs):
        if not isinstance(xs, torch.Tensor):
            xs = torch.from_numpy(np.asarray(xs, dtype=np.int64)
                                  & 0xFFFFFFFF)
        if xs.dim() != 1 or xs.shape[0] % dp:
            raise ValueError(f"{tuple(xs.shape)} seeds do not split over "
                             f"dp={dp}")
        b = xs.shape[0] // dp
        outs, hists = {}, {}
        for i in range(dp):
            out, _placed = bulk.map_rule(
                ruleno, xs[i * b:(i + 1) * b], reweights=reweights,
                result_max=result_max, device=mesh.device(i, 0))
            hists[(i, 0)] = _histogram(out, n_osds)
            for j in range(sp):
                outs[(i, j)] = out.to(mesh.device(i, j), non_blocking=True)
        summed = _psum(mesh, hists, "dp")
        hist = {(i, j): summed[(i, 0)].to(mesh.device(i, j),
                                          non_blocking=True)
                for i, j in mesh.shards()}
        return (Sharded(mesh, (xs.shape[0], outs[(0, 0)].shape[1]),
                        ("dp", None), outs),
                Sharded(mesh, (n_osds,), (None,), hist))
    return step

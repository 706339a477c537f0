"""Device-resident graph store: the dense-collated dataset in device memory.

The port's counterpart of ``deeprank_gnn_tpu/data/device_store.py``. The
dense layout gives every batch field a leading graph axis, so a whole
dataset collates into one :class:`DenseGraphBatch` of ``[N + 1, ...]``
fields (slot ``N`` is an all-padding graph). Uploading that once turns each
epoch's batch assembly into row gathers on the device (``index_select``)
instead of a host collation and a host-to-device copy per batch.

Fields pack into a few ``[slots, W]`` matrices, one per (segment, dtype
class), at halfword granularity: index fields and masks as 16-bit words
(held as ``int16``, widened with ``& 0xFFFF``), integer-valued operators
(in-degrees, the 0/1 pooled adjacency) the same way, and raw fp32 payloads
as fp32, or as bf16 under ``pack="bf16"`` (the one lossy option). The
encoding of each field follows from the dense capacities alone
(:func:`static_field_kinds`), so every chunk of a dataset packs to one
layout and :func:`estimate_store_bytes` is exact; both return what the JAX
package returns for the same capacities. On a mesh every rank builds the
whole store on its own device (the loader's ``store_sharding``), the
port's form of the JAX package's store replicated over the mesh.

:class:`ChunkedGraphStore` keeps a dataset beyond the byte budget packed in
page-locked host memory and rotates it through the device two chunks at a
time: the next chunk's copy runs on a side stream while the current
chunk's batches are gathered, and the gathers wait on the copy's event, so
no batch synchronizes the device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, fields
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeprank_gnn_tpu_torch import trace
from deeprank_gnn_tpu_torch.data.dense_batch import DenseGraphBatch, collate_dense

# collate granularity while building the store: bounds peak host memory
# without per-graph call overhead
_CHUNK = 256

# fields are segmented by use: a model reads whole segment rows
_SEGMENT_OF = {
    "deg0": "opcore", "adj1": "opcore",
    "assign0": "opcore", "pool0_mask": "opcore",
    "assign1": "opcore", "pool1_mask": "opcore",
    "mem0_idx": "opcore", "mem1_idx": "opcore",
    "y": "opcore", "y_mask": "opcore",
    # the two level-1 aggregation actions each get their own segment: a
    # model reads one of them (GINet's feature-major path opfm, the others
    # aggx)
    "agg_x": "aggx",
    "agg_x_fm": "opfm", "node_mask_fm": "opfm",
    "tile_mem0": "opfm", "tile_assign0": "opfm",
    "x": "x",
    "node_mask": "nmask",
    "row": "edges", "col": "edges", "edge_attr": "edges",
    "edge_mask": "edges", "edge_to_pe": "edges",
    "pe_row": "edges", "pe_col": "edges", "pe_mask": "edges",
    # edge-attribute-weighted operators (sGAT only)
    "wagg_x": "wop", "ea_rowsum0": "wop",
    "wadj1": "wop", "ea_rowsum1": "wop",
}

# fields that store as bf16 under pack="bf16" (raw fp32 payloads; y stays
# exact); everything else is lossless 16-bit or exact fp32
_BF16_OK = frozenset(
    {"x", "edge_attr", "agg_x", "agg_x_fm", "wagg_x", "wadj1",
     "ea_rowsum0", "ea_rowsum1"}
)

@dataclass(frozen=True)
class PackedStore:
    """A few ``[slots, W]`` matrices holding a dense dataset (or one
    chunk of it). ``layout`` is ``(name, segment, start, stop, shape,
    kind)`` per field, start and stop in columns of the segment's matrix,
    ``kind`` one of "f32", "i32", "bf16", "u16i", "u16b", "u16f". ``ready``
    is the event a chunk's copy records on its side stream (None when the
    matrices were placed synchronously)."""

    segments: dict
    layout: tuple
    ready: Optional[object] = None

    @property
    def num_slots(self) -> int:
        return next(iter(self.segments.values())).shape[0]


def static_field_kinds(
    *, ng: int, eg: int, pg: int, c0g: int, c1g: int, pack: str = "lossless"
) -> dict:
    """Per-field halfword encodings from the dense capacities alone, no
    data inspection (JAX ``device_store.py`` ``static_field_kinds``): every
    chunk packs to the same layout and :func:`estimate_store_bytes` is
    exact. Index fields take u16 when their pad sentinel (the capacity)
    fits, else i32; ``deg0`` and ``adj1`` are integer-valued and widen
    exactly from u16; raw fp32 payloads stay fp32 unless ``pack='bf16'``."""
    u16max = np.iinfo(np.uint16).max

    def idx(bound):
        return "u16i" if bound <= u16max else "i32"

    def cnt(bound):
        return "u16f" if bound <= u16max else "f32"

    def pay(name):
        return "bf16" if pack == "bf16" and name in _BF16_OK else "f32"

    return {
        "node_mask": "u16b", "edge_mask": "u16b", "pool0_mask": "u16b",
        "pe_mask": "u16b", "pool1_mask": "u16b", "y_mask": "u16b",
        "row": idx(ng), "col": idx(ng),
        "assign0": idx(c0g), "edge_to_pe": idx(pg),
        "pe_row": idx(c0g), "pe_col": idx(c0g), "assign1": idx(c1g),
        "mem0_idx": idx(ng), "mem1_idx": idx(c0g),
        "tile_mem0": idx(ng), "tile_assign0": idx(c0g),
        "node_mask_fm": "u16b",
        "deg0": cnt(eg), "adj1": cnt(1),
        "agg_x_fm": pay("agg_x_fm"),
        "x": pay("x"), "edge_attr": pay("edge_attr"),
        "agg_x": pay("agg_x"), "wagg_x": pay("wagg_x"),
        "ea_rowsum0": pay("ea_rowsum0"), "wadj1": pay("wadj1"),
        "ea_rowsum1": pay("ea_rowsum1"), "y": "f32",
    }


def _field_class(kind: str) -> str:
    """The class matrix a field encoding packs into: u16 kinds share one,
    fp32, int32 and bf16 payloads pack in their own dtype."""
    if kind in ("u16i", "u16f", "u16b"):
        return "u16"
    if kind in ("f32", "i32", "bf16"):
        return kind
    raise ValueError(kind)


def _to_typed(v: np.ndarray, kind: str, name: str = "?") -> torch.Tensor:
    """``[slots, ...]`` field -> ``[slots, W]`` CPU tensor of its class
    dtype (u16 words held as int16 bits). u16 kinds check the bound the static layout relies on (index <=
    capacity, operator integer-valued) and raise rather than truncate."""
    flat = np.ascontiguousarray(v.reshape(v.shape[0], -1))
    if kind == "f32":
        return torch.from_numpy(flat.astype(np.float32, copy=False))
    if kind == "i32":
        return torch.from_numpy(flat.astype(np.int32, copy=False))
    if kind == "bf16":
        # round to nearest even, as the JAX package's ml_dtypes cast does
        return torch.from_numpy(flat.astype(np.float32)).to(torch.bfloat16)
    if kind in ("u16i", "u16f"):
        if flat.size and not (
            flat.min() >= 0
            and flat.max() <= np.iinfo(np.uint16).max
            and (kind == "u16i" or np.all(flat == np.floor(flat)))
        ):
            raise ValueError(
                f"field {name!r} violates its static u16 encoding (out of "
                "[0, 65535] or non-integer): a collation invariant is broken"
            )
    elif kind != "u16b":
        raise ValueError(kind)
    return torch.from_numpy(flat.astype(np.uint16).view(np.int16))


def _pack_host(batch: DenseGraphBatch, pack: str = "lossless") -> Tuple[dict, tuple]:
    """Every non-None field of a CPU :class:`DenseGraphBatch` packed into
    per-(segment, class) ``[slots, W]`` matrices, and the layout.
    ``pack``: "lossless" (every field round-trips exactly) or "bf16" (raw
    fp32 payloads are rounded to bfloat16)."""
    if pack not in ("lossless", "bf16"):
        raise ValueError(f"pack must be 'lossless' or 'bf16', got {pack!r}")
    kinds = static_field_kinds(
        ng=batch.x.shape[1], eg=batch.row.shape[1], pg=batch.pe_row.shape[1],
        c0g=batch.pool0_mask.shape[1], c1g=batch.pool1_mask.shape[1], pack=pack,
    )
    cols: dict = {}
    layout = []
    for f in fields(DenseGraphBatch):
        v = getattr(batch, f.name)
        if v is None:
            continue
        kind = kinds[f.name]
        seg = f"{_SEGMENT_OF[f.name]}:{_field_class(kind)}"
        w = _to_typed(v.numpy(), kind, f.name)
        start = sum(c.shape[1] for c in cols.get(seg, []))
        cols.setdefault(seg, []).append(w)
        layout.append((f.name, seg, start, start + w.shape[1], tuple(v.shape[1:]), kind))
    segments = {s: torch.cat(ws, dim=1).contiguous() for s, ws in cols.items()}
    return segments, tuple(layout)


def unpack_rows(gathered: dict, layout: tuple) -> DenseGraphBatch:
    """A :class:`DenseGraphBatch` from per-segment gathered rows
    (``{segment: [g, W]}``): per field a column slice, widened or cast
    elementwise, reshaped to the field's shape."""
    vals = {f.name: None for f in fields(DenseGraphBatch)}
    for name, seg, start, stop, shape, kind in layout:
        rows = gathered[seg]
        w = rows[:, start:stop]
        if kind in ("u16i", "u16f"):
            w = w.to(torch.int32) & 0xFFFF
            if kind == "u16f":
                w = w.to(torch.float32)
        elif kind == "u16b":
            w = w != 0
        elif kind == "bf16":
            w = w.to(torch.float32)
        vals[name] = w.reshape((rows.shape[0],) + tuple(shape))
    return DenseGraphBatch(**vals)


def gather_packed(store: PackedStore, idx: torch.Tensor) -> DenseGraphBatch:
    """Row-gather every segment at ``idx`` (a tensor on the store's
    device) and rebuild the batch."""
    return unpack_rows({s: rows.index_select(0, idx) for s, rows in store.segments.items()},
                       store.layout)


def estimate_store_bytes(
    n_graphs: int,
    ng: int,
    eg: int,
    pg: int,
    c0g: int,
    c1g: int,
    num_features: int,
    num_edge_features: int,
    precompute_ops: bool = True,
    pack: str = "lossless",
    m0g: int = 0,
    m1g: int = 0,
    mt0g: int = 0,
) -> int:
    """Bytes of the packed store for ``n_graphs`` (+1 pad slot), from the
    same :func:`static_field_kinds` table :func:`_pack_host` packs with,
    counting one alignment word per segment (JAX
    ``device_store.py`` ``estimate_store_bytes``). Byte budgets
    (``device_cache_bytes``, chunk sizing) rely on it never undershooting."""
    g = n_graphs + 1
    kinds = static_field_kinds(ng=ng, eg=eg, pg=pg, c0g=c0g, c1g=c1g, pack=pack)
    hw = {"u16b": 1, "u16i": 1, "u16f": 1, "bf16": 1, "i32": 2, "f32": 2}
    elems = {
        "x": ng * num_features, "node_mask": ng,
        "row": eg, "col": eg,
        "edge_attr": eg * num_edge_features, "edge_mask": eg,
        "assign0": ng, "pool0_mask": c0g, "edge_to_pe": eg,
        "pe_row": pg, "pe_col": pg, "pe_mask": pg,
        "assign1": c0g, "pool1_mask": c1g,
        "y": 1, "y_mask": 1,
    }
    if precompute_ops:
        elems.update({"agg_x": ng * num_features, "deg0": ng,
                      "adj1": c0g * c0g,
                      "mem0_idx": c0g * m0g, "mem1_idx": c1g * m1g,
                      "agg_x_fm": ng * num_features,
                      "node_mask_fm": ng,
                      "tile_mem0": c0g * max(mt0g, 1),
                      "tile_assign0": ng // 8})
        if num_edge_features == 1:
            elems.update({
                "wagg_x": ng * num_features, "ea_rowsum0": ng,
                "wadj1": c0g * c0g, "ea_rowsum1": c0g,
            })
    per_hw = sum(n * hw[kinds[f]] for f, n in elems.items())
    per_hw += len({_SEGMENT_OF[f] for f in elems})  # alignment word, worst case
    return g * per_hw * 2


def _mt0g_from_plans(plans, mt0g=None):
    """Tile member capacity (most tiles of one level-0 cluster) of the
    run-padded layout, from the plans when not given."""
    if mt0g is not None:
        return mt0g
    best = 1
    for p in plans:
        if getattr(p, "cluster0", None) is not None and len(p.cluster0):
            lens = np.bincount(p.cluster0)
            best = max(best, int((-(-lens // 8)).max()))
    return best


def _concat_batches(parts: Sequence[DenseGraphBatch]) -> DenseGraphBatch:
    """Field-wise concatenation over the graph axis (None stays None)."""
    return DenseGraphBatch(**{
        f.name: (None if getattr(parts[0], f.name) is None
                 else torch.cat([getattr(p, f.name) for p in parts]))
        for f in fields(DenseGraphBatch)
    })


def _index(idx: np.ndarray, device: torch.device) -> torch.Tensor:
    """Slot indices on ``device``; to a CUDA device through page-locked
    memory, so the copy is asynchronous and synchronizes nothing."""
    t = torch.from_numpy(idx.astype(np.int64))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class DeviceGraphStore:
    """A dense-collated dataset packed once into ``device`` memory.

    ``samples``/``plans`` come from the loader's caches; the capacities are
    the loader's dataset-wide dense capacities. ``batch(indices, g_pad)``
    gathers the batch of store slots ``indices``, padded to ``g_pad`` with
    the all-padding slot, on the device. Its ``y``/``y_mask`` are CPU
    tensors from the store's host copy (``y_host``, ``y_mask_host``), so
    target remapping and metrics never read the device.
    """

    def __init__(
        self,
        samples: Sequence,
        plans: Sequence,
        *,
        ng: int,
        eg: int,
        pg: int,
        c0g: int,
        c1g: int,
        num_features: int,
        num_edge_features: int,
        device="cuda",
        precompute_ops: bool = True,
        pack: str = "lossless",
        m0g: int = 8,
        m1g: int = 8,
        mt0g: "int | None" = None,
    ):
        if len(samples) != len(plans):
            raise ValueError("samples/plans length mismatch")
        self.device = torch.device(device)
        self.mols: List[str] = [s.mol for s in samples]
        # the same names as one array, for a scanned epoch's plan to take
        # a pass's names with one gather
        self.mol_array = np.empty(len(self.mols), dtype=object)
        self.mol_array[:] = self.mols
        self.pad_slot = len(samples)
        caps = dict(
            ng=ng, eg=eg, pg=pg, c0g=c0g, c1g=c1g, m0g=m0g, m1g=m1g,
            mt0g=_mt0g_from_plans(plans, mt0g),
            num_features=num_features, num_edge_features=num_edge_features,
            precompute_ops=precompute_ops,
        )
        chunks = []
        with trace.span("store.collate"):
            for start in range(0, len(samples), _CHUNK):
                part = list(samples[start: start + _CHUNK])
                chunks.append(collate_dense(part, g_pad=len(part),
                                            plans=list(plans[start: start + _CHUNK]), **caps)[0])
            # trailing all-padding slot: partial batches gather it
            chunks.append(collate_dense([], g_pad=1, **caps)[0])
        host = _concat_batches(chunks)
        self.y_host = host.y.numpy()
        self.y_mask_host = host.y_mask.numpy()
        self.node_counts = host.node_mask.sum(dim=1).numpy()
        self.edge_counts = host.edge_mask.sum(dim=1).numpy()
        self.caps = dict(
            ng=ng, eg=eg, pg=pg, c0g=c0g, c1g=c1g,
            num_features=num_features, num_edge_features=num_edge_features,
        )
        with trace.span("store.pack"):
            segments, layout = _pack_host(host, pack)
        self.nbytes = sum(m.numel() * m.element_size() for m in segments.values())
        with trace.span("store.upload"):
            segments = {s: m.to(self.device) for s, m in segments.items()}
        self.store = PackedStore(segments=segments, layout=layout)

    @property
    def num_graphs(self) -> int:
        return self.pad_slot

    def batch(self, indices: np.ndarray, g_pad: int) -> Tuple[DenseGraphBatch, List[str]]:
        """The batch of store slots ``indices``, gathered on the device."""
        idx = np.full(g_pad, self.pad_slot, dtype=np.int64)
        idx[: len(indices)] = indices
        batch = gather_packed(self.store, _index(idx, self.device))
        batch = dataclasses.replace(batch, y=torch.from_numpy(self.y_host[idx]),
                                    y_mask=torch.from_numpy(self.y_mask_host[idx]))
        return batch, [self.mols[int(i)] for i in indices]


class ChunkedGraphStore:
    """Rotating device residency for datasets beyond the byte budget.

    The dataset is packed on the host once, into fixed consecutive chunks
    (each with its own trailing pad slot) in page-locked memory when the
    device is a card. During an epoch the loader uploads chunk i+1 while
    batches gather from chunk i, so at most two chunks are on the device
    (``chunk_bytes`` should be half the budget): the copy runs on a side
    stream and records an event that the gathering stream waits on, and
    each uploaded matrix is marked as used by the gathering stream, so the
    allocator reuses none of it while a gather may still read it.

    Shuffling is hierarchical (chunk order, then the order within each
    chunk; batches never span chunks), as in the JAX package.
    """

    def __init__(
        self,
        samples: Sequence,
        plans: Sequence,
        *,
        ng: int,
        eg: int,
        pg: int,
        c0g: int,
        c1g: int,
        num_features: int,
        num_edge_features: int,
        precompute_ops: bool = True,
        chunk_bytes: int,
        pack: str = "lossless",
        batch_size: Optional[int] = None,
        m0g: int = 8,
        m1g: int = 8,
        mt0g: "int | None" = None,
        device="cuda",
    ):
        if len(samples) != len(plans):
            raise ValueError("samples/plans length mismatch")
        self.device = torch.device(device)
        mt0g = _mt0g_from_plans(plans, mt0g)
        caps = dict(
            ng=ng, eg=eg, pg=pg, c0g=c0g, c1g=c1g, m0g=m0g, m1g=m1g, mt0g=mt0g,
            num_features=num_features, num_edge_features=num_edge_features,
            precompute_ops=precompute_ops,
        )
        per_slot = estimate_store_bytes(
            1, ng=ng, eg=eg, pg=pg, c0g=c0g, c1g=c1g, m0g=m0g, m1g=m1g, mt0g=mt0g,
            num_features=num_features, num_edge_features=num_edge_features,
            precompute_ops=precompute_ops, pack=pack,
        ) // 2
        slots = max(1, chunk_bytes // per_slot - 1)
        if batch_size and batch_size > 1:
            # batches never span chunks: round down to a batch multiple, so
            # no chunk's tail batch is mostly padding; one batch per chunk
            # is the floor
            slots = max(batch_size, slots // batch_size * batch_size)
        pin = self.device.type == "cuda"
        self.mols: List[str] = [s.mol for s in samples]
        self.chunk_ranges: List[Tuple[int, int]] = []
        self._host_chunks: List[Tuple[dict, tuple]] = []
        ys, yms, ncs, ecs = [], [], [], []
        pad = collate_dense([], g_pad=1, **caps)[0]
        for start in range(0, len(samples), slots):
            part = list(samples[start: start + slots])
            host = _concat_batches([
                collate_dense(part, g_pad=len(part), plans=list(plans[start: start + slots]),
                              **caps)[0],
                pad,
            ])
            ys.append(host.y.numpy()[:-1])
            yms.append(host.y_mask.numpy()[:-1])
            ncs.append(host.node_mask.sum(dim=1).numpy()[:-1])
            ecs.append(host.edge_mask.sum(dim=1).numpy()[:-1])
            segs, layout = _pack_host(host, pack)
            if pin:
                segs = {s: m.pin_memory() for s, m in segs.items()}
            self._host_chunks.append((segs, layout))
            self.chunk_ranges.append((start, len(part)))
        self.y_host = np.concatenate(ys)
        self.y_mask_host = np.concatenate(yms)
        self.node_counts = np.concatenate(ncs)
        self.edge_counts = np.concatenate(ecs)
        self.caps = dict(
            ng=ng, eg=eg, pg=pg, c0g=c0g, c1g=c1g,
            num_features=num_features, num_edge_features=num_edge_features,
        )
        self.chunk_nbytes = max(
            sum(m.numel() * m.element_size() for m in segs.values())
            for segs, _ in self._host_chunks
        )
        self._copy_stream = None

    @property
    def num_graphs(self) -> int:
        return len(self.mols)

    @property
    def num_chunks(self) -> int:
        return len(self._host_chunks)

    def copy_stream(self):
        """The side stream chunk copies run on (made on first use)."""
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        return self._copy_stream

    def upload(self, ci: int) -> PackedStore:
        """Start the copy of chunk ``ci`` to the device. On a card it runs
        on the side stream and returns at once; its ``ready`` event orders
        the gathers after it."""
        segs, layout = self._host_chunks[ci]
        if self.device.type != "cuda":
            return PackedStore(segments=dict(segs), layout=layout)
        consumer = torch.cuda.current_stream(self.device)
        side = self.copy_stream()
        with torch.cuda.stream(side):
            out = {s: m.to(self.device, non_blocking=True) for s, m in segs.items()}
            ready = torch.cuda.Event()
            ready.record(side)
        for t in out.values():
            t.record_stream(consumer)
        return PackedStore(segments=out, layout=layout, ready=ready)

    def empty_chunk(self) -> PackedStore:
        """Uninitialized device matrices in the chunks' layout, with the rows
        of the largest chunk and its pad slot: the fixed buffers a scanned
        epoch's captured step reads (``train/scan.py``), which
        :meth:`upload_into` fills chunk by chunk."""
        segs, layout = self._host_chunks[0]
        rows = max(clen for _, clen in self.chunk_ranges) + 1
        return PackedStore(
            segments={s: torch.empty((rows, m.shape[1]), dtype=m.dtype, device=self.device)
                      for s, m in segs.items()},
            layout=layout)

    def upload_into(self, ci: int, dst: PackedStore, extra=(), after=None):
        """Copy chunk ``ci`` (its rows and its pad slot) into the first rows
        of ``dst``'s matrices, and each host tensor of the ``(host, device)``
        pairs of ``extra`` into its device tensor. On a card the copies run
        on the side stream, after the event ``after`` (when given: the last
        read of ``dst``), and the event they record is returned, for the
        reading stream to wait on; on the CPU they run at once (None)."""
        segs, _ = self._host_chunks[ci]
        pairs = [(m, dst.segments[s][: m.shape[0]]) for s, m in segs.items()] + list(extra)
        if self.device.type != "cuda":
            for src, out in pairs:
                out.copy_(src)
            return None
        side = self.copy_stream()
        with torch.cuda.stream(side):
            if after is not None:
                side.wait_event(after)
            for src, out in pairs:
                out.copy_(src, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        return ready

    def batch(self, store: PackedStore, ci: int, local: np.ndarray,
              g_pad: int) -> Tuple[DenseGraphBatch, List[str]]:
        """Batch from an uploaded chunk: ``local`` are chunk-local slots;
        the chunk's own pad slot fills the remainder."""
        start, clen = self.chunk_ranges[ci]
        idx = np.full(g_pad, clen, dtype=np.int64)
        idx[: len(local)] = local
        if store.ready is not None:
            torch.cuda.current_stream(self.device).wait_event(store.ready)
        batch = gather_packed(store, _index(idx, self.device))
        gl = np.minimum(start + idx, self.num_graphs - 1)
        y = np.where(idx < clen, self.y_host[gl], 0.0).astype(np.float32)
        ym = (idx < clen) & self.y_mask_host[gl]
        batch = dataclasses.replace(batch, y=torch.from_numpy(y), y_mask=torch.from_numpy(ym))
        return batch, [self.mols[start + int(i)] for i in local]


def _loader_samples(loader):
    """The loader's cached samples and plans in dataset order, skipping
    unreadable ones, and each dataset index's store slot."""
    ds = loader.dataset
    samples, plans, slot_of_index = [], [], {}
    for i in range(len(ds)):
        s = loader._get_sample(i)
        if s is None:
            continue
        slot_of_index[i] = len(samples)
        samples.append(s)
        plans.append(loader._get_plan(i, s))
    return samples, plans, slot_of_index


def build_chunked_store_from_loader(loader, chunk_bytes: int) -> Optional[ChunkedGraphStore]:
    """A loader's dataset as a :class:`ChunkedGraphStore` on the loader's
    device (host-packed; chunks upload per epoch)."""
    if loader._dense_caps is None:
        return None
    samples, plans, slot_of_index = _loader_samples(loader)
    if not samples:
        return None
    nf, ef = loader.dataset.feature_dims()
    caps = dict(loader._dense_caps)
    caps.setdefault("pg", caps["eg"])
    store = ChunkedGraphStore(
        samples, plans, num_features=nf, num_edge_features=ef,
        precompute_ops=loader.precompute_ops, pack=loader.store_pack,
        chunk_bytes=chunk_bytes, batch_size=loader.batch_size, device=loader.device, **caps,
    )
    store.slot_of_index = slot_of_index
    return store


def build_store_from_loader(loader) -> Optional[DeviceGraphStore]:
    """A loader's dataset as a :class:`DeviceGraphStore` on the loader's
    device; None when the dataset is empty. Uses the loader's sample and
    plan caches, so a later streaming fallback costs nothing extra."""
    if loader._dense_caps is None:
        return None
    samples, plans, slot_of_index = _loader_samples(loader)
    if not samples:
        return None
    nf, ef = loader.dataset.feature_dims()
    caps = dict(loader._dense_caps)
    caps.setdefault("pg", caps["eg"])
    store = DeviceGraphStore(
        samples, plans, num_features=nf, num_edge_features=ef, device=loader.device,
        precompute_ops=loader.precompute_ops, pack=loader.store_pack, **caps,
    )
    store.slot_of_index = slot_of_index
    # the same map as a dense table, -1 where the store leaves an index out
    store.slot_table = np.full(len(loader.dataset), -1, dtype=np.int64)
    store.slot_table[list(slot_of_index)] = list(slot_of_index.values())
    return store

"""Host-side data pipeline: threaded decode -> fixed-size canvases -> device
(a copy of cutmix_seg_tpu.data.loader). With a ``data.resident`` store the
builder runs in index mode instead: no decode, only row indices, sizes and
the sampled geometry.

Replaces the reference's torch DataLoader worker-process machinery
(reference: train_seg_semisup_mask_mt.py:199-217, datapipe/seg_data.py) with a
device-shaped design: the host only decodes images and places them on fixed-size
uint8 canvases (zero-filled beyond the true extent; labels 255-filled) and
samples the per-sample geometric parameters; every per-pixel operation
(warp, flip, colour, normalisation, mask generation) runs on device inside
the train iteration. Static canvas/crop shapes keep every device tensor of
an iteration the same size.

Sampling semantics match the reference loaders: an infinite stream over the
index subset, reshuffled every pass (RepeatSampler over SubsetRandomSampler;
seg_data.py:281-308).
"""

from __future__ import annotations

import collections
import queue as queue_mod
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from cutmix_seg_tpu_torch.aug.params import (
    GeomConfig,
    sample_geom_pair,
    sample_geom_single,
)


class InfiniteShuffler:
    """Infinite index stream: reshuffle the subset every pass."""

    def __init__(self, indices: Sequence[int], rng: np.random.RandomState):
        self.indices = np.asarray(indices)
        self.rng = rng
        self._pos = 0
        self._order = self.rng.permutation(len(self.indices))

    def take(self, n: int) -> np.ndarray:
        out = []
        while n > 0:
            avail = len(self._order) - self._pos
            if avail == 0:
                self._order = self.rng.permutation(len(self.indices))
                self._pos = 0
                continue
            k = min(n, avail)
            out.append(self.indices[self._order[self._pos:self._pos + k]])
            self._pos += k
            n -= k
        return np.concatenate(out)


class DecodeCache:
    """Bounded LRU cache of decoded (image, labels) arrays."""

    def __init__(self, max_items: int = 1024):
        self.max_items = max_items
        self._cache = collections.OrderedDict()
        self._lock = threading.Lock()

    def get(self, key, fn):
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                return self._cache[key]
        val = fn()
        with self._lock:
            self._cache[key] = val
            self._cache.move_to_end(key)
            while len(self._cache) > self.max_items:
                self._cache.popitem(last=False)
        return val


def ship_window_hw(geom: Optional[GeomConfig], canvas_hw) -> Optional[Tuple[int, int]]:
    """Host->device transfer window for constant-border geometry modes.

    For plain crops the device only ever samples a crop-sized source region;
    for the Hung crop-scale scheme at most crop/0.5 per dim. Shipping just
    that window (sliced from the zero-padded canvas, matrix re-anchored)
    instead of the whole canvas cuts H2D traffic up to 4x (e.g. Cityscapes:
    512x1024 canvas vs 256x512 crop) with bit-identical results — every
    sampling tap lies inside the window and out-of-extent taps are constant-0
    either way. Reflect-border mode (crop_rotate_scale) must see the full
    image extent for edge reflection, so it ships the full canvas (None).
    """
    if geom is None:
        return None
    ch, cw = geom.crop_size
    if geom.mode == "crop":
        need = (ch + 2, cw + 2)
    elif geom.mode == "crop_scale_hung":
        # scale factor >= 0.5 => source region <= 2x crop
        need = (2 * ch + 2, 2 * cw + 2)
    else:
        return None
    if need[0] >= canvas_hw[0] and need[1] >= canvas_hw[1]:
        return None
    return (min(need[0], canvas_hw[0]), min(need[1], canvas_hw[1]))


class HostBatchBuilder:
    """Builds numpy canvas batches + per-sample geometry for the device stage."""

    def __init__(
        self,
        source,
        geom: Optional[GeomConfig],
        with_labels: bool,
        pair_geom: bool = False,
        canvas_hw: Optional[Tuple[int, int]] = None,
        cache_items: int = 1024,
        n_threads: int = 8,
        ship_window: bool = True,
        resident=None,
    ):
        """``resident``: a data.resident.ResidentDataset; switches the
        builder to INDEX mode: no decode, no canvas assembly; batches carry
        only resident row indices ('idx'), true sizes and the sampled
        geometry (the trainer gathers the canvases on the device). The
        geometry draws are those of streaming mode, in the same order."""
        self.source = source
        self.geom = geom
        self.with_labels = with_labels
        self.pair_geom = pair_geom
        self.canvas_hw = canvas_hw or source.canvas_hw
        self.resident = resident
        self.window_hw = (
            ship_window_hw(geom, self.canvas_hw)
            if ship_window and resident is None else None
        )
        self.cache = DecodeCache(cache_items)
        self.pool = ThreadPoolExecutor(max_workers=n_threads)

    def _window_origin(self, ms, img_hw):
        """Top-left of the transfer window: cover the preimage of the crop
        under every matrix in ms, clamped into the canvas."""
        from cutmix_seg_tpu_torch.aug import affine as A

        ch, cw = self.geom.crop_size
        corners = np.array(
            [[0.0, 0.0, 1.0], [cw - 1.0, 0.0, 1.0],
             [0.0, ch - 1.0, 1.0], [cw - 1.0, ch - 1.0, 1.0]])
        mins = np.array([np.inf, np.inf])
        for m in ms:
            inv = A.invert(m[None].astype(np.float64))[0]
            src = corners @ inv.T  # (4, 2) x,y
            mins = np.minimum(mins, src.min(axis=0)[::-1])  # -> (y, x)
        origin = np.floor(mins).astype(int) - 1  # bilinear tap margin
        wh, ww = self.window_hw
        origin[0] = np.clip(origin[0], 0, max(self.canvas_hw[0] - wh, 0))
        origin[1] = np.clip(origin[1], 0, max(self.canvas_hw[1] - ww, 0))
        return origin

    def _decode(self, i: int):
        def load():
            img = self.source.get_image(int(i))
            lab = self.source.get_labels(int(i)) if self.with_labels else None
            return img, lab

        return self.cache.get(int(i), load)

    def _sample_geoms(self, img_sizes, rng):
        geoms = []
        for k in range(len(img_sizes)):
            if self.pair_geom:
                geoms.append(sample_geom_pair(
                    self.geom, tuple(img_sizes[k]), rng, self.with_labels))
            else:
                geoms.append((sample_geom_single(
                    self.geom, tuple(img_sizes[k]), rng, self.with_labels),))
        return geoms

    def _build_index_mode(self, indices, rng) -> Dict[str, np.ndarray]:
        b = len(indices)
        rows = self.resident.rows(indices)
        img_sizes = self.resident.sizes_host[rows].astype(np.int32)
        out = {"idx": rows, "sizes": img_sizes}
        if self.geom is not None:
            geoms = self._sample_geoms(img_sizes, rng)
            n_g = 2 if self.pair_geom else 1
            ms = [np.zeros((b, 2, 3), np.float32) for _ in range(n_g)]
            interp = [np.zeros((b,), np.int32) for _ in range(n_g)]
            for k in range(b):
                for gi, (m, it) in enumerate(geoms[k]):
                    ms[gi][k] = m
                    interp[gi][k] = it
            if self.pair_geom:
                out.update({"m0": ms[0], "m1": ms[1],
                            "interp0": interp[0], "interp1": interp[1]})
            else:
                out.update({"m": ms[0], "interp": interp[0]})
        return out

    def build(self, indices: np.ndarray, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
        from cutmix_seg_tpu_torch.aug import affine as A

        if self.resident is not None:
            return self._build_index_mode(indices, rng)
        b = len(indices)
        decoded = list(self.pool.map(self._decode, indices))
        img_sizes = np.array([d[0].shape[:2] for d in decoded], np.int32)
        for k, (h, w) in enumerate(img_sizes):
            if h > self.canvas_hw[0] or w > self.canvas_hw[1]:
                raise ValueError(
                    f"image {indices[k]} ({h}x{w}) exceeds canvas {self.canvas_hw}"
                )

        # geometry first: the transfer window depends on the sampled matrices
        geoms = (self._sample_geoms(img_sizes, rng)
                 if self.geom is not None else None)

        window = self.window_hw if geoms is not None else None
        ch, cw = window if window is not None else self.canvas_hw
        canvas = np.zeros((b, ch, cw, 3), np.uint8)
        # uint8 keeps host->device label traffic at 1 byte/px (255 = ignore)
        labels = np.full((b, ch, cw), 255, np.uint8) if self.with_labels else None
        sizes = np.zeros((b, 2), np.int32)
        out_ms = [np.zeros((b, 2, 3), np.float32) for _ in range(
            2 if self.pair_geom else 1)] if geoms is not None else []
        out_interp = [np.zeros((b,), np.int32) for _ in range(
            2 if self.pair_geom else 1)] if geoms is not None else []

        for k, (img, lab) in enumerate(decoded):
            h, w = img_sizes[k]
            if window is not None:
                origin = self._window_origin(
                    [g[0] for g in geoms[k]], (h, w))
                oy, ox = int(origin[0]), int(origin[1])
                eh = int(np.clip(h - oy, 0, ch))
                ew = int(np.clip(w - ox, 0, cw))
                canvas[k, :eh, :ew] = img[oy:oy + eh, ox:ox + ew]
                if labels is not None and eh and ew:
                    labels[k, :eh, :ew] = lab[oy:oy + eh, ox:ox + ew]
                sizes[k] = (eh, ew)
                shift = A.translation(
                    np.array([[ox, oy]], dtype=np.float64))
                for gi, (m, interp) in enumerate(geoms[k]):
                    out_ms[gi][k] = A.compose(
                        m[None].astype(np.float64), shift)[0]
                    out_interp[gi][k] = interp
            else:
                canvas[k, :h, :w] = img
                if labels is not None:
                    labels[k, :h, :w] = lab
                sizes[k] = (h, w)
                if geoms is not None:
                    for gi, (m, interp) in enumerate(geoms[k]):
                        out_ms[gi][k] = m
                        out_interp[gi][k] = interp

        out = {"canvas": canvas, "sizes": sizes}
        if labels is not None:
            out["labels"] = labels
        if geoms is not None:
            if self.pair_geom:
                out.update({"m0": out_ms[0], "m1": out_ms[1],
                            "interp0": out_interp[0], "interp1": out_interp[1]})
            else:
                out.update({"m": out_ms[0], "interp": out_interp[0]})
        return out


class PrefetchIterator:
    """Runs a producer callable on a background thread with a bounded queue."""

    def __init__(self, producer, depth: int = 2):
        self.producer = producer
        self.queue: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self.stop_flag = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            while not self.stop_flag.is_set():
                item = self.producer()
                self.queue.put(item)
        except Exception as e:  # surface producer errors to the consumer
            self.queue.put(e)

    def __next__(self):
        item = self.queue.get()
        if isinstance(item, Exception):
            raise item
        return item

    def __iter__(self):
        return self

    def close(self):
        self.stop_flag.set()
        try:
            self.queue.get_nowait()
        except queue_mod.Empty:
            pass


def train_stream(
    builder: HostBatchBuilder,
    indices: Sequence[int],
    batch_size: int,
    seed: int,
    prefetch: int = 2,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite prefetched stream of host batches over an index subset."""
    sampler_rng = np.random.RandomState(seed)
    param_rng = np.random.RandomState(seed + 1)
    shuffler = InfiniteShuffler(indices, sampler_rng)

    def produce():
        return builder.build(shuffler.take(batch_size), param_rng)

    return PrefetchIterator(produce, depth=prefetch)


def eval_batches(
    source,
    indices: Sequence[int],
    batch_size: int,
    block_size: Tuple[int, int] = (1, 1),
    with_labels: bool = True,
):
    """Fixed-shape eval batches: canvases padded to the dataset canvas rounded
    up to the architecture block size (one tensor shape for the whole pass).
    The final short batch is padded with repeats; 'count' gives the real
    number of samples (padded entries get labels all-255 so they cannot
    perturb the confusion matrix)."""
    ch = -(-source.canvas_hw[0] // block_size[0]) * block_size[0]
    cw = -(-source.canvas_hw[1] // block_size[1]) * block_size[1]
    builder = HostBatchBuilder(
        source, geom=None, with_labels=with_labels, canvas_hw=(ch, cw),
        cache_items=1,
    )
    indices = np.asarray(indices)
    rng = np.random.RandomState(0)
    for start in range(0, len(indices), batch_size):
        chunk = indices[start:start + batch_size]
        count = len(chunk)
        if count < batch_size:
            chunk = np.concatenate([chunk, chunk[:1].repeat(batch_size - count)])
        batch = builder.build(chunk, rng)
        if with_labels and count < batch_size:
            batch["labels"][count:] = 255
        batch["count"] = count
        batch["indices"] = chunk
        yield batch

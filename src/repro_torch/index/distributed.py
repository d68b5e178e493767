"""Mesh-sharded COBS query engine, the port of ``repro.index.distributed``.

Sharding layout (the JAX package's, over a ``repro_torch.launch.mesh``):

* arena columns (packed document words) shard over the ``doc_axes``
  (("pod", "data") on the production mesh): every position scans only its
  own documents, with no communication until result selection;
* arena rows optionally shard over ``row_axis`` ("model"): each position
  holds a horizontal stripe of the Bloom rows, a term's row lives on exactly
  one stripe, and the stripes' partial scores are summed (JAX's psum over
  the row axis). Row sharding requires n_hashes == 1: with k > 1 the AND
  over hash rows does not commute with the sum across stripes.

Result selection is a distributed top-k: a top-k of each document shard's
scores, its candidates (score, global slot) concatenated in flat doc-rank
order (JAX's all_gather), then a final top-k. Both cuts keep the lower
index first among equal scores, as ``jax.lax.top_k`` does, through a stable
descending sort (``torch.topk`` gives ties no order).

The port runs it as single-controller SPMD in one process, which is what
``shard_map`` is: each (doc shard, row stripe) slice of the arena lives on
the device of its first mesh position and is scored there by one kernel
launch a batch (``lookup_score_multi`` over [Q, nb, L] for 'lookup',
``vertical_score`` / ``unpack_score`` over [Q, L, nb * Wl] otherwise).
Positions that differ only along an axis the sharding does not name hold
the same slice (JAX replicates it); the port keeps and scores it once. The
sums and the concatenation run on ``device``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import dna, hashing
from ..core.index import BitSlicedIndex
from ..core.query import plan_rows
from ..device import resolve_device
from ..kernels import ops
from ..launch.mesh import Mesh


def _pad_to(x: np.ndarray, axis: int, multiple: int) -> np.ndarray:
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths)


def _top(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row and their indices, the lower index
    first among ties (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


class DistributedIndex:
    """A BitSlicedIndex resident on a device mesh.

    doc_axes: mesh axes sharding the document (word-column) dimension.
    row_axis: optional mesh axis sharding the Bloom-row dimension.
    score_dtype: dtype of the partial scores and their sum over the row
    stripes (int16 halves the bytes summed; exact while ell <= 32767).
    device: where the stripes' sums and the top-k merge run (None = the
    CUDA card); each slice runs on its mesh position's device.
    """

    def __init__(self, index: BitSlicedIndex, mesh: Mesh,
                 doc_axes: tuple[str, ...] = ("data",),
                 row_axis: str | None = None,
                 score_method: str = "vertical",
                 score_dtype=torch.int32, device=None):
        if row_axis is not None and index.params.n_hashes != 1:
            raise ValueError("row sharding requires n_hashes == 1 "
                             "(AND over hashes does not commute with psum)")
        doc_axes = tuple(doc_axes)
        named = doc_axes + ((row_axis,) if row_axis else ())
        if (not set(named) <= set(mesh.axis_names)
                or len(set(named)) != len(named)):
            raise ValueError(f"axes {named} are not distinct axes of the "
                             f"mesh {mesh.axis_names}")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.doc_axes = doc_axes
        self.row_axis = row_axis
        self.params = index.params
        self.score_method = score_method
        self.score_dtype = score_dtype
        self.n_docs = index.n_docs

        self.n_doc_shards = math.prod(mesh.shape[a] for a in doc_axes)
        n_row_shards = mesh.shape[row_axis] if row_axis else 1

        # full_host reads mmapped shards directly: index.arena would first
        # concatenate an out-of-core index dense in device memory
        arena = index.storage.full_host()
        arena = _pad_to(arena, 1, self.n_doc_shards)   # pad doc words
        arena = _pad_to(arena, 0, n_row_shards)        # pad rows (zeros,
        self.doc_words = arena.shape[1]                # never addressed)
        self.total_rows = arena.shape[0]
        self.row_stripe = self.total_rows // n_row_shards
        self.words_local = self.doc_words // self.n_doc_shards
        self.n_blocks = index.n_blocks
        self.slots_per_block = self.doc_words * 32

        # (doc rank, row rank) -> (device, arena slice, row_offset,
        # block_width); the doc rank is row-major over doc_axes in the
        # order given, as jax.lax.axis_index(doc_axes) numbers it
        row_offset = np.asarray(index.layout.row_offset)
        block_width = np.asarray(index.layout.block_width)
        self.slices: dict[tuple[int, int], tuple] = {}
        axis = {a: i for i, a in enumerate(mesh.axis_names)}
        for pos in np.ndindex(*mesh.devices.shape):
            d = int(np.ravel_multi_index(
                tuple(pos[axis[a]] for a in doc_axes),
                tuple(mesh.shape[a] for a in doc_axes)))
            m = pos[axis[row_axis]] if row_axis else 0
            if (d, m) in self.slices:
                continue
            dev = resolve_device(mesh.devices[pos])
            part = np.ascontiguousarray(
                arena[m * self.row_stripe:(m + 1) * self.row_stripe,
                      d * self.words_local:(d + 1) * self.words_local])
            self.slices[(d, m)] = (
                dev, torch.from_numpy(part.view(np.int32)).to(dev),
                torch.from_numpy(row_offset).to(dev),
                torch.from_numpy(block_width).to(dev))
        doc_slot = np.asarray(index.layout.doc_slot)
        # original-id lookup: slot -> doc id (-1 for padding slots). Doc i
        # sits at block b = slot // block_docs, position pos; after column
        # padding a block holds slots_per_block slots, so the padded slot is
        # b * slots_per_block + pos.
        self.slot_doc = np.full(self.n_blocks * self.slots_per_block, -1,
                                dtype=np.int64)
        b = doc_slot // index.block_docs
        pos = doc_slot % index.block_docs
        padded_slots = b * self.slots_per_block + pos
        self.slot_doc[padded_slots] = np.arange(index.n_docs)
        self._padded_doc_slot = padded_slots  # int64 [n_docs]
        # score_fn() output is SHARD-major (each doc shard's [nb*Wl*32]
        # scores side by side along the doc axis):
        #   flat = shard*(nb*Wl*32) + block*(Wl*32) + word_local*32 + bit
        word, bit = pos // 32, pos % 32
        shard_of = word // self.words_local
        word_l = word % self.words_local
        per_shard = self.n_blocks * self.words_local * 32
        self._flat_doc_slot = (shard_of * per_shard
                               + b * self.words_local * 32 + word_l * 32 + bit)

    # ------------------------------------------------------------------
    def _slice_scores(self, arena_l, row_offset, block_width, m: int,
                      terms: torch.Tensor, n_valid: torch.Tensor
                      ) -> torch.Tensor:
        """One slice's partial scores of a batch, one kernel launch:
        terms int32 [Q, L, 2], n_valid [Q] -> score_dtype [Q, nb*Wl*32]."""
        n_hashes = self.params.n_hashes
        Q, L = terms.shape[0], terms.shape[1]
        h = hashing.hash_terms(terms, n_hashes)              # [Q, L, k]
        rows = plan_rows(h, row_offset, block_width)         # [Q, L, k, nb]
        valid = (torch.arange(L, device=terms.device)[None, :]
                 < n_valid[:, None])                         # [Q, L]
        if self.row_axis is not None:
            base = m * self.row_stripe
            local = rows - base
            own = (local >= 0) & (local < self.row_stripe)
            local = local.clamp(0, self.row_stripe - 1)
        else:
            local, own = rows, None
        if self.score_method == "lookup" and n_hashes == 1:
            # fused path: rows stream straight from the arena slice, the
            # gathered [Q, L, nb, Wl] copy never materialises
            idx = local[:, :, 0, :].transpose(1, 2).contiguous()  # [Q, nb, L]
            msk = valid[:, None, :].expand(idx.shape)
            if own is not None:
                msk = msk & own[:, :, 0, :].transpose(1, 2)
            scores = ops.bitslice_lookup_score_multi(
                arena_l, idx, msk.to(torch.int32).contiguous())
            return scores.to(self.score_dtype)
        g = arena_l[local.long()]                            # [Q,L,k,nb,Wl]
        if own is not None:
            g = torch.where(own[..., None], g, 0)
        anded = g[:, :, 0]
        for i in range(1, n_hashes):
            anded = anded & g[:, :, i]
        anded = torch.where(valid[:, :, None, None], anded, 0)
        flat = anded.reshape(Q, L, self.n_blocks * self.words_local)
        method = ("vertical" if self.score_method == "lookup"
                  else self.score_method)
        return ops.bitslice_score(flat, method=method).to(self.score_dtype)

    def _shard_scores(self, terms: np.ndarray, n_valid: np.ndarray
                      ) -> list[torch.Tensor]:
        """Every doc shard's scores on ``device``, the row stripes' partial
        scores summed in score_dtype: a list over doc ranks of
        [Q, nb*Wl*32]."""
        terms = np.ascontiguousarray(terms, dtype=np.uint32).view(np.int32)
        n_valid = np.asarray(n_valid, dtype=np.int32)
        inputs: dict[torch.device, tuple] = {}
        out: list[torch.Tensor | None] = [None] * self.n_doc_shards
        for (d, m), (dev, arena_l, ro, bw) in sorted(self.slices.items()):
            if dev not in inputs:
                inputs[dev] = (torch.from_numpy(terms).to(dev),
                               torch.from_numpy(n_valid).to(dev))
            part = self._slice_scores(arena_l, ro, bw, m,
                                      *inputs[dev]).to(self.device)
            out[d] = part if out[d] is None else out[d] + part
        return out

    def score_fn(self):
        """(terms uint32 [Q, L, 2], n_valid [Q]) -> scores [Q, n_slots] on
        ``device`` (shard-major slot order, see ``_flat_doc_slot``)."""
        def score(terms, n_valid):
            return torch.cat(self._shard_scores(terms, n_valid), dim=1)
        return score

    def topk_fn(self, topk: int):
        """(terms, n_valid) -> (scores [Q, topk'], slots [Q, topk']) on
        ``device``, topk' = min(topk, shards * min(topk, shard slots)):
        each shard's top-k, gathered in doc-rank order, cut again."""
        def top(terms, n_valid):
            vals_g, slot_g = [], []
            for d, scores in enumerate(self._shard_scores(terms, n_valid)):
                vals, idx = _top(scores, min(topk, scores.shape[1]))
                blk = idx // (self.words_local * 32)
                rem = idx % (self.words_local * 32)
                word_l, bit = rem // 32, rem % 32
                vals_g.append(vals)
                slot_g.append(blk * self.slots_per_block
                              + (d * self.words_local + word_l) * 32 + bit)
            vals_g = torch.cat(vals_g, dim=1)                # [Q, P*k]
            slot_g = torch.cat(slot_g, dim=1)
            best_v, pos = _top(vals_g, min(topk, vals_g.shape[1]))
            return best_v, torch.gather(slot_g, 1, pos)
        return top

    # ------------------------------------------------------------------
    def search_batch(self, patterns: list, threshold: float = 0.8,
                     topk: int = 32, term_pad: int = 64):
        """Batched search mirroring QueryEngine.search_batch, through the
        sharded engine; returns per-query (doc_ids, scores)."""
        term_sets = []
        for p in patterns:
            codes = dna.encode_dna(p) if isinstance(p, str) else p
            term_sets.append(dna.unique_terms(
                dna.pack_kmers(codes, self.params.kmer,
                               self.params.canonical)))
        ells = np.array([t.shape[0] for t in term_sets], dtype=np.int32)
        pad = max(term_pad, ((int(ells.max(initial=1)) + term_pad - 1)
                             // term_pad) * term_pad)
        buf = np.zeros((len(patterns), pad, 2), dtype=np.uint32)
        for i, t in enumerate(term_sets):
            buf[i, :t.shape[0]] = t
        vals, slots = self.topk_fn(topk)(buf, ells)
        vals, slots = vals.cpu().numpy(), slots.cpu().numpy()
        out = []
        for i, ell in enumerate(ells):
            cut = max(1, math.ceil(threshold * int(ell)))
            ids = self.slot_doc[slots[i]]
            keep = (vals[i] >= cut) & (ids >= 0)
            out.append((ids[keep].astype(np.int32), vals[i][keep]))
        return out

    def scores_for(self, terms: np.ndarray, term_pad: int = 64) -> np.ndarray:
        """Full score vector in ORIGINAL document order (test/oracle path)."""
        L = terms.shape[0]
        pad = max(term_pad, ((L + term_pad - 1) // term_pad) * term_pad)
        buf = np.zeros((1, pad, 2), dtype=np.uint32)
        buf[0, :L] = terms
        slots = self.score_fn()(buf, np.asarray([L], dtype=np.int32))
        return slots.cpu().numpy()[0][self._flat_doc_slot]

"""Binary bag-of-words: building the vocabulary, and the BoW retrieval bank.

The port's counterpart of ``uzliti_slam_tpu/recognition/vocabulary.py``
(the reference's DBoW2 path: its offline vocabulary generator and the
``BinaryBowRecognizer``).  The vocabulary is a flat k-majority codebook of
K packed 256-bit words with an idf weight each; a descriptor set becomes
the L1-normalised tf-idf vector over the words, and retrieval is the DBoW2
L1 score.

- ``build_vocabulary``: farthest-point seeding from a first descriptor
  (drawn from a ``torch.Generator``, or given), then k-majority rounds, each
  an assignment and a majority update (K23's ``word_assign`` and
  ``word_majority``); an empty word is reseeded with the descriptors
  farthest from their words; the idf from a last assignment.
- ``quantize`` (K23's ``word_assign``) and ``bow_score``.
- ``BowBank``, ``bow_bank_init/add/remove`` and ``bow_query`` (K24).
- ``from_numpy``: a vocabulary made elsewhere (the reference's), as
  tensors on a device: the vocabulary is this system's weights.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from uzliti_slam_tpu_torch import _device
from uzliti_slam_tpu_torch.graph.state import set_row
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.recognition.recognizer import slot_mask, drop_nodes, scalar


class Vocabulary(NamedTuple):
    centers: torch.Tensor  # (K, 32) uint8 packed binary words
    idf: torch.Tensor      # (K,) float32 inverse document frequencies


def from_numpy(centers, idf, device=None) -> Vocabulary:
    """A vocabulary from host arrays (``centers`` (K, 32) uint8, ``idf``
    (K,) float32) on ``device`` (default: the CUDA card)."""
    device = _device.resolve(device)
    return Vocabulary(
        centers=torch.from_numpy(np.array(centers, dtype=np.uint8)).to(device),
        idf=torch.from_numpy(np.array(idf, dtype=np.float32)).to(device))


def build_vocabulary(desc: torch.Tensor, valid: torch.Tensor | None = None, k: int = 256,
                     iterations: int = 8, generator: torch.Generator | None = None,
                     first=None) -> Vocabulary:
    """k-majority clustering of binary descriptors ``desc`` (M, 32) uint8
    (``valid`` (M,) mask) into ``k`` words, on ``desc``'s device.

    Seeding is farthest-point: the first seed is ``first`` (an index, or a
    () tensor) or else drawn among the valid descriptors with
    ``generator``; each next one is the valid descriptor farthest from the
    seeds so far (the first among equals).  Each of ``iterations`` rounds
    assigns every descriptor to its nearest word and sets each bit of a
    word that more than half its valid members have; a word without
    members takes, in word order, the valid descriptors farthest from their
    words (a stable order).  idf = log(max(#valid, 1) / (1 + members))."""
    dev, m = desc.device, desc.shape[0]
    valid = torch.ones(m, dtype=torch.bool, device=dev) if valid is None else valid
    desc = desc.contiguous()
    if first is None:
        p = valid.to(torch.float32)
        first = torch.multinomial(p / torch.clamp(p.sum(), min=1.0), 1, generator=generator)[0]
    last = scalar(first, torch.int64, dev)
    mindist = torch.full((m,), torch.inf, device=dev)
    chosen = []
    for _ in range(k):
        chosen.append(last)
        # one word, the last seed: the distance of every descriptor to it
        _, d, _ = kops.word_assign(desc, valid, desc.index_select(0, last.view(1)))
        mindist = torch.minimum(mindist, d.to(torch.float32))
        last = torch.argmax(torch.where(valid, mindist, -1.0))
    centers = desc.index_select(0, torch.stack(chosen))

    inf = torch.full((), torch.inf, device=dev)
    for _ in range(iterations):
        word, dist, counts = kops.word_assign(desc, valid, centers)
        new = kops.word_majority(desc, valid, word, counts)
        empty = counts == 0
        far = torch.where(valid, -dist.to(torch.float32), inf)
        order = torch.sort(far, stable=True).indices
        rank = torch.clamp(torch.cumsum(empty, 0) - 1, 0, m - 1)
        centers = torch.where(empty[:, None], desc.index_select(0, order[rank]), new)

    _, _, n_word = kops.word_assign(desc, valid, centers)
    n_total = torch.clamp(valid.sum().to(torch.float32), min=1.0)
    idf = torch.log(n_total / (1.0 + n_word.to(torch.float32)))
    return Vocabulary(centers=centers, idf=idf)


def quantize(vocab: Vocabulary, desc: torch.Tensor, valid: torch.Tensor | None = None):
    """Descriptor set (F, 32) -> L1-normalised tf-idf BoW vector (K,): the
    valid descriptors' word histogram (K23) times max(idf, 0)."""
    if valid is None:
        valid = torch.ones(desc.shape[0], dtype=torch.bool, device=desc.device)
    _, _, tf = kops.word_assign(desc.contiguous(), valid.contiguous(),
                                vocab.centers.contiguous())
    v = tf.to(torch.float32) * torch.clamp(vocab.idf, min=0.0)
    return v / torch.clamp(torch.sum(torch.abs(v)), min=1e-12)


def bow_score(va: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score in [0, 1]: 1 - ½‖va - vb‖₁ of L1-normalised vectors,
    over the last dimension."""
    return 1.0 - 0.5 * torch.sum(torch.abs(va - vb), dim=-1)


# ---------------------------------------------------------------------------
# BoW retrieval bank
# ---------------------------------------------------------------------------

class BowBank(NamedTuple):
    vec: torch.Tensor    # (N, K) float32 L1-normalised tf-idf vectors per node slot
    stamp: torch.Tensor  # (N,) float32
    valid: torch.Tensor  # (N,) bool


def bow_bank_init(capacity: int, k_words: int, device=None) -> BowBank:
    device = _device.resolve(device)
    return BowBank(vec=torch.zeros(capacity, k_words, dtype=torch.float32, device=device),
                   stamp=torch.zeros(capacity, dtype=torch.float32, device=device),
                   valid=torch.zeros(capacity, dtype=torch.bool, device=device))


def bow_bank_add(bank: BowBank, slot, vec: torch.Tensor, stamp) -> BowBank:
    """The bank with ``vec`` and ``stamp`` written at ``slot``, unchanged
    where ``slot`` < 0."""
    dev = bank.vec.device
    slot = scalar(slot, torch.int64, dev)
    ok = slot >= 0
    idx = torch.clamp(slot, min=0)
    return BowBank(vec=set_row(bank.vec, idx, ok, vec),
                   stamp=set_row(bank.stamp, idx, ok, scalar(stamp, torch.float32, dev)),
                   valid=set_row(bank.valid, idx, ok, True))


def bow_bank_remove(bank: BowBank, slot) -> BowBank:
    return drop_nodes(bank, slot_mask(bank.valid, slot))


def bow_query(bank: BowBank, vec: torch.Tensor, stamp, k: int = 10, min_score: float = 0.05,
              min_dt: float = 5.0):
    """The k best nodes by L1 BoW score (K24), excluding invalid rows, zero
    vectors on either side (two zero vectors would score 1) and rows within
    ``min_dt`` of ``stamp``.  Returns (slots (k,) int32, scores (k,)
    float32, ok (k,): score >= min_score)."""
    dev = bank.vec.device
    return kops.bow_query(bank.vec.contiguous(), bank.stamp.contiguous(),
                          bank.valid.contiguous(), vec.contiguous(),
                          scalar(stamp, torch.float32, dev), k, float(min_score), float(min_dt))

"""Place recognition over fixed-capacity banks, and the pair gate of the
keyframe step.

The port's counterpart of ``uzliti_slam_tpu/recognition/recognizer.py``.
Each recognizer queries for the k best nodes that lie at least ``min_dt``
seconds away, ties to the lower slot:

- ``GistBank`` — one 256-bit GIST per node slot, the nearest within a
  Hamming distance (K16's ``gist_topk``; the default method);
- ``FeatureSetBank`` — each node's descriptor set; a node's similarity is
  the fraction of valid query descriptors with a stored descriptor within
  a Hamming threshold (K21 ``feature_votes``; the reference's default
  ``lsh`` method);
- ``FeatureRepository`` — a bank of unique descriptors, each with links to
  the nodes that saw it; ``repository_add`` links a close match or appends
  a novel descriptor (K22's ``repo_nearest``), ``repository_query`` votes
  for the nodes linked to the descriptors the query hits (K22's
  ``repo_votes``).

``mask_existing_pairs`` drops candidate pairs that already have an edge.
The bag-of-words bank is in ``vocabulary``.  Banks are functional: an
update returns new tensors.  No function reads the device on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from uzliti_slam_tpu_torch import _device
from uzliti_slam_tpu_torch.graph.state import set_row, set_rows
from uzliti_slam_tpu_torch.kernels import ops as kops

MIN_TIME_SEPARATION = 5.0  # seconds


class GistBank(NamedTuple):
    desc: torch.Tensor    # (N, 32) uint8 binary GIST per node slot
    stamp: torch.Tensor   # (N,) float32
    valid: torch.Tensor   # (N,) bool


def scalar(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` as a () tensor on ``device``: a tensor is moved, a number is
    filled in on the device (no host-to-device copy, no synchronisation)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).reshape(())
    return torch.full((), x, dtype=dtype, device=device)


def gist_bank_init(capacity: int, device=None) -> GistBank:
    device = _device.resolve(device)
    return GistBank(desc=torch.zeros(capacity, 32, dtype=torch.uint8, device=device),
                    stamp=torch.zeros(capacity, dtype=torch.float32, device=device),
                    valid=torch.zeros(capacity, dtype=torch.bool, device=device))


def gist_bank_add(bank: GistBank, slot, desc: torch.Tensor, stamp) -> GistBank:
    """The bank with ``desc`` and ``stamp`` written at ``slot``, or unchanged
    where ``slot`` < 0.  Functional."""
    dev = bank.desc.device
    slot = scalar(slot, torch.int64, dev)
    ok = slot >= 0
    idx = torch.clamp(slot, min=0)
    return GistBank(desc=set_row(bank.desc, idx, ok, desc),
                    stamp=set_row(bank.stamp, idx, ok, scalar(stamp, torch.float32, dev)),
                    valid=set_row(bank.valid, idx, ok, True))


def drop_nodes(bank, dead: torch.Tensor):
    """``bank`` (a bank with a per-node ``valid`` flag) with the nodes of
    ``dead`` (N,) bool made unsearchable; reads nothing on the host."""
    return bank._replace(valid=bank.valid & ~dead)


def slot_mask(valid: torch.Tensor, slot) -> torch.Tensor:
    """(N,) bool: True at ``slot`` only (nowhere where ``slot`` < 0)."""
    slot = scalar(slot, torch.int64, valid.device)
    return torch.arange(valid.shape[0], device=valid.device) == slot


def gist_bank_remove(bank: GistBank, slot) -> GistBank:
    return drop_nodes(bank, slot_mask(bank.valid, slot))


def gist_query(bank: GistBank, desc: torch.Tensor, stamp, k: int = 10, max_dist: float = 60.0,
               min_dt: float = MIN_TIME_SEPARATION):
    """The k nearest GIST entries within Hamming ``max_dist``, excluding
    invalid entries and entries within ``min_dt`` of ``stamp`` (K16).
    Returns (slots (k,) int32, dists (k,) float32, ok (k,) bool)."""
    dev = bank.desc.device
    return kops.gist_topk(desc.contiguous(), bank.desc.contiguous(), bank.stamp.contiguous(),
                          bank.valid.contiguous(), scalar(stamp, torch.float32, dev), k,
                          float(min_dt), float(max_dist))


def mask_existing_pairs(e_from, e_to, e_valid, cand_a, cand_b) -> torch.Tensor:
    """False for each candidate pair (a, b) that an edge of ``e_valid``
    already joins, in either direction."""
    pa, pb = torch.minimum(cand_a, cand_b), torch.maximum(cand_a, cand_b)
    ea, eb = torch.minimum(e_from, e_to), torch.maximum(e_from, e_to)
    dup = (pa[:, None] == ea[None, :]) & (pb[:, None] == eb[None, :]) & e_valid[None, :]
    return ~torch.any(dup, dim=-1)


# ---------------------------------------------------------------------------
# Per-node feature-set bank
# ---------------------------------------------------------------------------

class FeatureSetBank(NamedTuple):
    """Per-node descriptor sets.  ``process_keyframe`` assembles one from
    the state's descriptor arrays at each step; ``feature_bank_init/add``
    keep a bank of their own, as the reference's functions do."""
    desc: torch.Tensor        # (N, F, 32) uint8 descriptors per node
    desc_valid: torch.Tensor  # (N, F) bool
    stamp: torch.Tensor       # (N,) float32
    valid: torch.Tensor       # (N,) bool: searchable (enough descriptors)


def feature_bank_init(capacity: int, feats_per_node: int, device=None) -> FeatureSetBank:
    device = _device.resolve(device)
    return FeatureSetBank(
        desc=torch.zeros(capacity, feats_per_node, 32, dtype=torch.uint8, device=device),
        desc_valid=torch.zeros(capacity, feats_per_node, dtype=torch.bool, device=device),
        stamp=torch.zeros(capacity, dtype=torch.float32, device=device),
        valid=torch.zeros(capacity, dtype=torch.bool, device=device))


def feature_bank_add(bank: FeatureSetBank, slot, desc: torch.Tensor, desc_valid: torch.Tensor,
                     stamp, min_descriptors: float = 50) -> FeatureSetBank:
    """The bank with a node's descriptor set written at ``slot`` (unchanged
    where ``slot`` < 0); the node is searchable only with at least
    ``min_descriptors`` valid descriptors."""
    dev = bank.desc.device
    slot = scalar(slot, torch.int64, dev)
    ok = slot >= 0
    idx = torch.clamp(slot, min=0)
    return FeatureSetBank(
        desc=set_row(bank.desc, idx, ok, desc), desc_valid=set_row(bank.desc_valid, idx, ok,
                                                                   desc_valid),
        stamp=set_row(bank.stamp, idx, ok, scalar(stamp, torch.float32, dev)),
        valid=set_row(bank.valid, idx, ok, desc_valid.sum() >= min_descriptors))


def feature_bank_remove(bank: FeatureSetBank, slot) -> FeatureSetBank:
    return drop_nodes(bank, slot_mask(bank.valid, slot))


def feature_set_query(bank: FeatureSetBank, desc: torch.Tensor, desc_valid: torch.Tensor, stamp,
                      k: int = 10, hamming_thresh: float = 40.0, min_similarity: float = 0.2,
                      min_dt: float = MIN_TIME_SEPARATION):
    """Vote-based retrieval: similarity(node) = fraction of the valid query
    descriptors ``desc`` (F, 32) whose nearest valid descriptor of the node
    lies within ``hamming_thresh`` (K21).  Returns (slots (k,) int32, sims
    (k,) float32, ok (k,): sim >= min_similarity)."""
    dev = bank.desc.device
    return kops.feature_votes(desc.contiguous(), desc_valid.contiguous(), bank.desc.contiguous(),
                              bank.desc_valid.contiguous(), bank.stamp.contiguous(),
                              bank.valid.contiguous(), scalar(stamp, torch.float32, dev), k,
                              float(hamming_thresh), float(min_similarity), float(min_dt))


# ---------------------------------------------------------------------------
# Global feature repository
# ---------------------------------------------------------------------------

class FeatureRepository(NamedTuple):
    desc: torch.Tensor        # (D, 32) uint8 unique descriptors
    desc_valid: torch.Tensor  # (D,) bool
    links: torch.Tensor       # (D, L) int32 node slots that saw each descriptor
    link_valid: torch.Tensor  # (D, L) bool
    num_desc: torch.Tensor    # () int32 descriptors appended, at most D
    node_stamp: torch.Tensor  # (N,) float32 stamps for the time gate
    node_valid: torch.Tensor  # (N,) bool


def repository_init(desc_capacity: int, links_per_desc: int, node_capacity: int,
                    device=None) -> FeatureRepository:
    device = _device.resolve(device)
    return FeatureRepository(
        desc=torch.zeros(desc_capacity, 32, dtype=torch.uint8, device=device),
        desc_valid=torch.zeros(desc_capacity, dtype=torch.bool, device=device),
        links=torch.zeros(desc_capacity, links_per_desc, dtype=torch.int32, device=device),
        link_valid=torch.zeros(desc_capacity, links_per_desc, dtype=torch.bool, device=device),
        num_desc=torch.zeros((), dtype=torch.int32, device=device),
        node_stamp=torch.zeros(node_capacity, dtype=torch.float32, device=device),
        node_valid=torch.zeros(node_capacity, dtype=torch.bool, device=device))


def repository_add(repo: FeatureRepository, node_slot, desc: torch.Tensor,
                   desc_valid: torch.Tensor, stamp, match_thresh: float = 30.0,
                   ok=True) -> FeatureRepository:
    """Insert a node's descriptors: a valid descriptor within
    ``match_thresh`` of a stored one only links that one to the node; a
    novel one, unless a valid earlier descriptor of the same frame lies
    within ``match_thresh`` of it, is appended at the next slot (none past
    the capacity D), and linked.  A link goes into the first free slot of
    the descriptor's row (none where the row is full); two descriptors of
    the frame that reach the same stored one write the same slot, so one
    link each (target, frame), as the reference's single vectorised pass.
    The search is K22's ``repo_nearest``; the rest is masked writes.  With
    ``ok`` False (a () bool tensor) the repository comes back unchanged."""
    dev = repo.desc.device
    dcap, lcap = repo.links.shape
    ok = scalar(ok, torch.bool, dev)
    nn_dist, nn_idx, dup = kops.repo_nearest(desc.contiguous(), desc_valid.contiguous(),
                                             repo.desc.contiguous(), repo.desc_valid.contiguous(),
                                             float(match_thresh))
    live = desc_valid & ok
    is_match = (nn_dist <= match_thresh) & live
    is_new = ~is_match & live & ~dup
    new_slot = repo.num_desc + torch.cumsum(is_new, 0, dtype=torch.int32) - 1
    can_append = is_new & (new_slot < dcap)
    target = torch.where(is_match, nn_idx, torch.where(can_append, new_slot, 0)).long()
    write = is_match | can_append

    desc_arr = set_rows(repo.desc, new_slot, can_append, desc)
    dvalid = set_rows(repo.desc_valid, new_slot, can_append, can_append)

    row_valid = repo.link_valid[target]                           # (F, L)
    free = torch.argmin(row_valid.to(torch.uint8), dim=-1)       # the first free slot
    okk = write & ~row_valid.all(-1)
    flat = target * lcap + free
    links = set_rows(repo.links.reshape(-1), flat, okk,
                     scalar(node_slot, torch.int32, dev).expand(flat.shape)).reshape(dcap, lcap)
    link_valid = set_rows(repo.link_valid.reshape(-1), flat, okk, okk).reshape(dcap, lcap)

    ns = scalar(node_slot, torch.int64, dev)
    return FeatureRepository(
        desc=desc_arr, desc_valid=dvalid, links=links, link_valid=link_valid,
        num_desc=torch.clamp(repo.num_desc + can_append.sum(dtype=torch.int32),
                             max=dcap).to(torch.int32),
        node_stamp=set_row(repo.node_stamp, ns, ok, scalar(stamp, torch.float32, dev)),
        node_valid=set_row(repo.node_valid, ns, ok, True))


def repository_query(repo: FeatureRepository, desc: torch.Tensor, desc_valid: torch.Tensor,
                     stamp, k: int = 10, match_thresh: float = 30.0, min_votes: float = 5,
                     min_dt: float = MIN_TIME_SEPARATION):
    """Vote for the nodes linked to the stored descriptors that any valid
    query descriptor hits within ``match_thresh`` (K22's ``repo_votes``).
    Returns (slots (k,) int32, votes (k,) int32, ok (k,): votes >=
    min_votes)."""
    dev = repo.desc.device
    return kops.repo_votes(desc.contiguous(), desc_valid.contiguous(), repo.desc.contiguous(),
                           repo.desc_valid.contiguous(), repo.links.contiguous(),
                           repo.link_valid.contiguous(), repo.node_stamp.contiguous(),
                           repo.node_valid.contiguous(), scalar(stamp, torch.float32, dev), k,
                           float(match_thresh), float(min_votes), float(min_dt))

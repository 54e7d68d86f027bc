"""Shared device kernels: key normalization, lexicographic sort, grouping,
segmented reductions.

Port of the JAX package's ``ops/kernels.py`` (``_orderable_u32_words``,
``sort_key_passes``, ``_radix_perm``, ``lex_sort_perm``,
``key_fingerprint``, ``group_ids``, ``_seg_sum``, ``_seg_minmax``,
``segment_reduce``, ``segment_minmax_string``, ``_identity_for``).

- ``sort_key_passes`` turns a key column into u32 radix words, most
  significant first, adjusted for asc/desc and null ordering. A u32 word is
  an int64 tensor holding a value in [0, 2^32) (torch's uint32 lacks the
  arithmetic these need).
- ``_radix_perm`` is the stable LSD radix over those words; every word is
  one ``native.stable_argsort_u32`` call (kernel K1 on the card).
- ``group_ids`` sorts rows by a 64-bit key fingerprint (two murmur3
  streams + the null pattern) so equal keys become adjacent.
- ``segment_reduce`` reduces each group of group-sorted rows with Spark's
  null and NaN rules; its integer sums and every min/max are
  ``native.segment_sum_sorted`` / ``segment_minmax_sorted`` (kernel K2 on
  the card). Float sums take a scatter-add (``index_add_``), as the JAX
  package's take ``jax.ops.segment_sum``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, DeviceColumn, flush_subnormal)
from spark_rapids_tpu_torch.exprs import hash as mh
from spark_rapids_tpu_torch.ops import native

M32 = 0xFFFFFFFF
_SIGN32 = 0x80000000
_INT64_MIN = -(1 << 63)
_NAN_F64_BITS = 0x7FF8000000000000


def _full(like: torch.Tensor, value: int) -> torch.Tensor:
    return torch.full((), value, dtype=torch.int64, device=like.device)


# ---------------------------------------------------------------------------
# Orderable key normalization
# ---------------------------------------------------------------------------

def _orderable_u32_words(col: DeviceColumn,
                         flush: bool = True) -> List[torch.Tensor]:
    """Column -> u32 words (int64 carried), most-significant first, whose
    lexicographic unsigned order is SQL ascending order (nulls handled
    separately). ``flush`` orders f64 subnormals as zeros of their sign,
    as the reference's device half compares them."""
    t = col.dtype
    if t.is_string:
        # Big-endian 4-byte words: zero padding sorts shorter strings first.
        data = col.data
        w = data.shape[1]
        if w % 4:
            data = torch.cat([data, data.new_zeros((data.shape[0],
                                                    4 - w % 4))], dim=1)
        d = data.to(torch.int64)
        return [(d[:, i] << 24) | (d[:, i + 1] << 16) | (d[:, i + 2] << 8)
                | d[:, i + 3] for i in range(0, w, 4)]
    if t.is_floating:
        if t.name == "float32":
            bits = col.data.to(torch.float32).view(torch.int32) \
                .to(torch.int64) & M32
            # IEEE total order: flip all bits if negative else flip sign.
            neg = (bits >> 31) == 1
            return [torch.where(neg, bits ^ M32, bits | _SIGN32)]
        # float64: the JAX package keeps these passes in the float domain
        # ([nan tier, value with NaNs zeroed, -0/+0 tiebreak]) because the
        # TPU cannot bitcast f64. A 64-bit bitcast is legal here; the IEEE
        # total-order transform with NaN canonicalized orders rows
        # identically (NaN greatest, -0.0 before +0.0, ties stable), so
        # the stable permutation is the same. Its float-domain compare
        # sees a subnormal as a zero of its sign, so they flush first.
        # (Its float32 words are bit patterns, which keep subnormals.)
        x = col.data.to(torch.float64)
        if flush:
            x = flush_subnormal(x)
        b = torch.where(torch.isnan(x), _full(x, _NAN_F64_BITS),
                        x.view(torch.int64))
        u = torch.where(b < 0, ~b, b | _INT64_MIN)
        return [(u >> 32) & M32, u & M32]
    if t.name in ("int64", "timestamp"):
        u = col.data.to(torch.int64) ^ _INT64_MIN
        return [(u >> 32) & M32, u & M32]
    # bool/int8/16/32/date -> one word, sign-bias flip.
    return [(col.data.to(torch.int64) & M32) ^ _SIGN32]


def sort_key_passes(col: DeviceColumn, ascending: bool,
                    nulls_first: bool, flush: bool = True
                    ) -> List[torch.Tensor]:
    """Radix word passes for one sort key, MSW first, including the null
    ordering word. Descending keys get bit-flipped words."""
    words = _orderable_u32_words(col, flush)
    if not ascending:
        words = [w ^ M32 for w in words]
    one, zero = _full(col.validity, 1), _full(col.validity, 0)
    if nulls_first:
        null_word = torch.where(col.validity, one, zero)
    else:
        null_word = torch.where(col.validity, zero, one)
    # Zero data words for nulls so null ordering is decided by null_word.
    words = [torch.where(col.validity, w, zero) for w in words]
    return [null_word] + words


def _radix_perm(passes: List[torch.Tensor], capacity: int,
                unstable_first: bool = False) -> torch.Tensor:
    """Stable LSD radix argsort over u32 word passes (most significant
    first); returns the int64 row permutation ordering rows by the
    lexicographic pass tuple.

    Every word is one ``native.stable_argsort_u32`` call (its library
    route with ``native.radixSort`` off): the least
    significant word sorts alone, every later one through the
    permutation so far (its gather, sort and gather in one call).
    ``unstable_first`` (stableSort.enabled off) allows any tie order on
    the least significant pass; the stable kernel is one such order, so
    it runs there too."""
    del unstable_first, capacity
    sort = native.stable_argsort_u32 if native.kernel_enabled("radixSort") \
        else native.stable_argsort_u32_library
    words = [w.contiguous() for w in reversed(passes)]
    perm = sort(words[0]).to(torch.int64)
    for w in words[1:]:
        perm = sort(w, perm)
    return perm


def lex_sort_perm(passes: List[torch.Tensor], live,
                  capacity: int, stable: bool = True) -> torch.Tensor:
    """Permutation sorting rows by the MSW-first word passes; dead rows
    always sort last. ``live`` is a (capacity,) bool mask or a row count
    (int or 0-d tensor)."""
    if not isinstance(live, torch.Tensor) or live.dim() == 0:
        dev = passes[0].device if passes else \
            (live.device if isinstance(live, torch.Tensor) else None)
        live = torch.arange(capacity, dtype=torch.int32, device=dev) < live
    pad_last = torch.where(live, _full(live, 0), _full(live, M32))
    return _radix_perm([pad_last] + list(passes), capacity,
                       unstable_first=not stable)


# ---------------------------------------------------------------------------
# Grouping
# ---------------------------------------------------------------------------

_SEED_A = 42
_SEED_B = 0x5EED


def key_fingerprint(cols: Sequence[DeviceColumn], capacity: int,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two independent 32-bit fingerprints of the key tuple per row.

    Null cells are normalized so all NULLs fingerprint identically, and
    the null pattern is mixed into the second stream explicitly (murmur3
    passes the seed through on null). ``device`` places the fingerprints
    of a key tuple with no columns."""
    dev = cols[0].validity.device if cols else device
    ha = torch.full((capacity,), _SEED_A, dtype=torch.int64, device=dev)
    hb = torch.full((capacity,), _SEED_B, dtype=torch.int64, device=dev)
    for i, c in enumerate(cols):
        if c.dtype.is_string:
            data = torch.where(c.validity[:, None], c.data,
                               torch.zeros_like(c.data))
            lens = torch.where(c.validity, c.lengths,
                               torch.zeros_like(c.lengths))
            c = DeviceColumn(c.dtype, data, c.validity, lens)
        elif c.dtype.is_floating:
            # Grouping equality: -0.0 == 0.0 and NaN == NaN (Spark's
            # NormalizeNaNAndZero, folded in here). Subnormals count as
            # zero too: the JAX device path compares with denormals as
            # zero, and its fingerprints are the reference.
            data = flush_subnormal(c.data)
            data = torch.where(data == 0, torch.zeros_like(data), data)
            data = torch.where(c.validity, data, torch.zeros_like(data))
            c = DeviceColumn(c.dtype, data, c.validity)
        else:
            data = torch.where(c.validity, c.data, torch.zeros_like(c.data))
            c = DeviceColumn(c.dtype, data, c.validity)
        ha = mh.hash_column(c, c.dtype, ha)
        hb = mh.hash_column(c, c.dtype, hb)
        nullbit = torch.where(c.validity, _full(ha, 0),
                              _full(ha, (0x9E3779B9 + i) & M32))
        hb = mh.fmix(hb ^ nullbit, 4)
    return ha, hb


@dataclasses.dataclass
class Grouping:
    """Result of group_ids: rows sorted so equal keys are adjacent."""

    perm: torch.Tensor             # (cap,) int64 row permutation
    group_of_sorted: torch.Tensor  # (cap,) int64 dense group id per row
    num_groups: torch.Tensor       # 0-d int32
    group_leader: torch.Tensor     # (cap,) int64 original row index of
    #                                each group's first sorted row


def group_ids(batch: DeviceBatch, key_ordinals: Sequence[int]) -> Grouping:
    """Assign dense group ids over the key columns."""
    cap = batch.capacity
    cols = [batch.columns[i] for i in key_ordinals]
    ha, hb = key_fingerprint(cols, cap, batch.device)
    live = batch.row_mask()
    # Sort rows by (live first, ha, hb): padding last.
    passes = [torch.where(live, _full(ha, 0), _full(ha, M32)), ha, hb]
    perm = _radix_perm(passes, cap)
    sa = ha.index_select(0, perm)
    sb = hb.index_select(0, perm)
    slive = live.index_select(0, perm)
    prev_a = torch.cat([sa[:1] ^ 1, sa[:-1]])
    prev_b = torch.cat([sb[:1], sb[:-1]])
    new_seg = ((sa != prev_a) | (sb != prev_b)) & slive
    idx = torch.arange(cap, dtype=torch.int64, device=perm.device)
    first_live = torch.argmax(slive.to(torch.int32))
    new_seg = new_seg | ((idx == first_live) & slive)
    gid = torch.cumsum(new_seg.to(torch.int64), 0) - 1
    gid = torch.where(slive, gid, _full(gid, max(cap - 1, 0)))
    num_groups = new_seg.sum(dtype=torch.int32)
    # Leader: original row index of each group's first sorted row
    # (``.at[].set(mode="drop")`` into a buffer one slot longer).
    leader = torch.zeros(cap + 1, dtype=torch.int64, device=perm.device)
    leader[torch.where(new_seg, gid, _full(gid, cap))] = perm
    return Grouping(perm, gid, num_groups, leader[:cap])


# ---------------------------------------------------------------------------
# Segmented reductions over group-sorted rows
# ---------------------------------------------------------------------------

def _scatter_sum(values: torch.Tensor, gid: torch.Tensor,
                 capacity: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: an ``index_add_`` into ``capacity`` slots
    (ids at or past ``capacity`` land in one extra slot, sliced off)."""
    out = torch.zeros(capacity + 1, dtype=values.dtype, device=values.device)
    out.index_add_(0, gid.clamp(max=capacity), values)
    return out[:capacity]


def _seg_sum(values: torch.Tensor, gid: torch.Tensor,
             capacity: int) -> torch.Tensor:
    """Per-group sums for nondecreasing ``gid``. Integers take the exact
    segment reduce (K2 on the card); floats a scatter-add, whose order of
    addition is not the JAX package's (float sums are compared within a
    tolerance)."""
    out = native.segment_sum_sorted(
        values, gid, capacity,
        library=not native.kernel_enabled("segmentReduce"))
    return _scatter_sum(values, gid, capacity) if out is None else out


def _seg_minmax(values: torch.Tensor, gid: torch.Tensor, capacity: int,
                kind: str) -> torch.Tensor:
    """Per-group min or max in the total-order bit domain (K2 on the
    card, its library route with ``native.segmentReduce`` off): -0.0
    below 0.0, subnormals kept, as the JAX package's Pallas kernel orders
    them."""
    return native.segment_minmax_sorted(
        values, gid, capacity, kind,
        library=not native.kernel_enabled("segmentReduce"))


def _full_like0(v: torch.Tensor, value) -> torch.Tensor:
    return torch.full((), value, dtype=v.dtype, device=v.device)


def segment_reduce(values: torch.Tensor, validity: torch.Tensor,
                   gid: torch.Tensor, capacity: int, kind: str):
    """Segmented aggregate with Spark null discipline.

    ``values``/``validity`` are in group-sorted order and ``gid`` is the
    group of each sorted row (nondecreasing). Returns (agg (capacity,),
    non-null count (capacity,) int64). ``kind``: sum | min | max. Floats
    follow Spark's NaN order (NaN greatest): min ignores NaN unless the
    group is all NaN, max is NaN whenever the group holds a valid NaN."""
    if kind == "sum":
        agg = _seg_sum(torch.where(validity, values, _full_like0(values, 0)),
                       gid, capacity)
    elif kind in ("min", "max"):
        if values.is_floating_point():
            isnan = torch.isnan(values)
            real = validity & ~isnan
            nanv = _full_like0(values, float("nan"))
            if kind == "min":
                masked = torch.where(real, values,
                                     _full_like0(values, float("inf")))
                m = _seg_minmax(masked, gid, capacity, "min")
                has_real = _seg_sum(real.to(torch.int32), gid, capacity) > 0
                agg = torch.where(has_real, m, nanv)
            else:
                masked = torch.where(real, values,
                                     _full_like0(values, float("-inf")))
                m = _seg_minmax(masked, gid, capacity, "max")
                has_nan = _seg_sum((validity & isnan).to(torch.int32), gid,
                                   capacity) > 0
                agg = torch.where(has_nan, nanv, m)
        else:
            masked = torch.where(validity, values,
                                 _identity_for(values, kind))
            agg = _seg_minmax(masked, gid, capacity, kind)
    else:
        raise ValueError(kind)
    counts = _seg_sum(validity.to(torch.int64), gid, capacity)
    return agg, counts


def segment_minmax_string(data: torch.Tensor, lengths: torch.Tensor,
                          validity: torch.Tensor, gid: torch.Tensor,
                          capacity: int, want_max: bool):
    """Per-group lexicographic min/max of a string column in group-sorted
    order: one more stable radix sort keyed by [gid, null-loses, value
    words, length] (K1 on the card), after which the first row of each gid
    run is the winner. Returns the (data, validity, lengths) buffer triple
    indexed by group id."""
    col = DeviceColumn(dt.STRING, data, validity, lengths)
    words = _orderable_u32_words(col)
    lens = lengths.to(torch.int64)
    if want_max:
        # Max also prefers the longer of two strings equal on a prefix:
        # flipping the words flips prefix order, not the implicit length
        # order, so the length word is flipped explicitly.
        words = [w ^ M32 for w in words]
        lenword = lens ^ M32
    else:
        lenword = lens
    zero = _full(validity, 0)
    loser = torch.where(validity, zero, _full(validity, M32))
    words = [torch.where(validity, w, zero) for w in words]
    lenword = torch.where(validity, lenword, zero)
    perm = _radix_perm([gid & M32, loser] + words + [lenword], capacity)
    sorted_gid = gid.index_select(0, perm)
    new_seg = torch.ones(capacity, dtype=torch.bool, device=gid.device)
    new_seg[1:] = sorted_gid[1:] != sorted_gid[:-1]
    winner = torch.zeros(capacity + 1, dtype=torch.int64, device=gid.device)
    winner[torch.where(new_seg, sorted_gid, _full(gid, capacity))
           .clamp(max=capacity)] = perm
    winner = winner[:capacity]
    has_valid = _scatter_sum(validity.to(torch.int32), gid, capacity) > 0
    out_data = torch.where(has_valid[:, None], data.index_select(0, winner),
                           torch.zeros((), dtype=data.dtype,
                                       device=data.device))
    out_lens = torch.where(has_valid, lengths.index_select(0, winner),
                           torch.zeros((), dtype=lengths.dtype,
                                       device=lengths.device))
    return out_data, has_valid, out_lens


def _identity_for(like: torch.Tensor, kind: str) -> torch.Tensor:
    """0-d identity of min/max for ``like``'s dtype: +/-inf, the bool
    extreme, or the integer type's max/min."""
    if like.is_floating_point():
        return _full_like0(like, float("inf") if kind == "min"
                           else float("-inf"))
    if like.dtype == torch.bool:
        return _full_like0(like, kind == "min")
    info = torch.iinfo(like.dtype)
    return _full_like0(like, info.max if kind == "min" else info.min)


def global_minmax(values: torch.Tensor, kind: str) -> torch.Tensor:
    """0-d min or max of a whole (masked) column in the total-order bit
    domain, the order ``_seg_minmax`` uses: -0.0 below 0.0 and subnormals
    kept. Unsigned order is signed order with the top bit flipped."""
    keys, dec = native._minmax_encode(values)
    sign = native._INT32_MIN if keys.dtype == torch.int32 \
        else native._INT64_MIN
    flipped = keys ^ sign
    m = flipped.min() if kind == "min" else flipped.max()
    return dec((m ^ sign).reshape(1))[0]

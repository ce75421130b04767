"""The host-fed native lane's three device functions: a CUDA kernel each
(``csrc/fused_kernels.cu``) and a plain PyTorch version each, with the
same signature.

- ``apply_pairs_u32`` (F1): fold the host's packed pair words
  ``pair << 12 | count`` into the count lane.
- ``apply_pairs_u16`` (F3): the same for ``[pair lo16, pair hi16,
  count]`` uint16 triples, the form for a pair count of 0xFFF or more or
  a pair domain past 20 bits.
- ``fused_step`` (F2): one upload per batch — a ``FUSED_HDR``-word
  header, then the pairs as F1's words or as F3's triples (``form``) —
  and one call: the pairs' apply, the
  fire of every window end the header lists with the top-n appended to
  the emit ring, and the purge of the columns its clear mask names.
  The card reads the header; the fire runs ``window_counts`` and
  ``topn_select_append``'s kernels and the purge ``ring_columns``'s,
  the same device code the host-driven path launches. With
  ``fire_gate`` the fire is skipped on the card when no end is valid
  and the purge when the clear mask is empty; the bytes are the same
  either way.

As in ``window_kernels.py``: a wrapper takes the plain version only for
tensors on the CPU and launches the kernel (or raises) for CUDA
tensors; ``window_kernels.LAUNCHES`` counts one launch per wrapper call
that reached the card (``fused_step`` is a chain of
``FUSED_STEP_KERNELS`` kernel launches). Pairs outside the state go to
no cell, silently, as in the reference. Integer work only: kernel,
plain version and JAX reference agree bit for bit.
"""
from __future__ import annotations


import torch

from flink_tpu_torch.kernels import window_kernels as wk

# the fused-step upload's header words, its window-end slots and the
# sentinels of an unused slot (flink_tpu/ops/window.py:570-590)
FUSED_HDR = 128
MIN_FIRE_PAD = 64
DELTA_SENTINEL = -(2 ** 30)
END_SENTINEL = -(2 ** 62)
# the widest ring whose clear mask the header carries (two words)
MAX_FUSED_RING = 64
# kernel launches of one fused step at top-1: the header decode and the
# apply in one, window counts, the top-n's two kernels (wk.topn_plan),
# purge
FUSED_STEP_KERNELS = 5
# the form of a fused step's pairs behind its header: F1's u32 words, or
# F3's uint16 triples (a launch argument; the header's words keep their
# meaning)
FORM_WORDS = 0
FORM_TRIPLES = 1

_SIGNATURES = {
    "ff_params_bytes": [],
    "ff_error_string": [wk.ctypes.c_int],
}


def _lib():
    return wk.load_library("fused_kernels", _SIGNATURES, "ff_error_string")


def _entry(fn: str, name: str, n_words: int) -> wk.LeanEntry:
    return wk.LeanEntry(_lib, fn, name, n_words, "ff_error_string")


_APPLY_PAIRS_U32 = _entry("ff_apply_pairs_u32", "apply_pairs_u32", 4)
_APPLY_PAIRS_U16 = _entry("ff_apply_pairs_u16", "apply_pairs_u16", 4)
_FUSED_STEP = _entry("ff_fused_step", "fused_step", 22)
# the fused step's parameter block, int32 words (ff_params_bytes), read
# at its first launch
_params_words = None


# -- F1 ----------------------------------------------------------------------

def apply_pairs_u32(counts: torch.Tensor, words: torch.Tensor,
                    dump_row: int) -> torch.Tensor:
    """``counts.view(-1)[pair] += count`` for each int32 word ``pair << 12
    | count`` (a logical shift), in place; a pair may repeat. A word with
    count 0xFFF (the padding word 0xFFFFFFFF) or a pair at or beyond
    ``dump_row * ring`` goes to no cell. The kernel reads four words a
    thread with 16-byte loads, any alignment and length of ``words``
    taken. Returns ``counts``."""
    index = wk.fast_index((counts, torch.int32, 2), (words, torch.int32, 1))
    if index is None:
        wk.check_tensor(counts, "counts", torch.int32, 2)
        wk.check_tensor(words, "words", torch.int32, 1)
        if not wk.on_cuda("apply_pairs_u32", counts, words):
            return apply_pairs_u32_plain(counts, words, dump_row)
        index = counts.get_device()
    _, stream = wk.launch_context(index)
    _APPLY_PAIRS_U32(stream, counts.data_ptr(), int(dump_row) * counts.shape[1],
                     words.data_ptr(), words.numel())
    return counts


def apply_pairs_u32_plain(counts, words, dump_row):
    pair = ((words >> 12) & 0xFFFFF).long()   # >> is arithmetic on int32
    cnt = words & 0xFFF
    ok = (cnt != 0xFFF) & (pair < int(dump_row) * counts.shape[1])
    counts.view(-1).index_add_(0, pair[ok], cnt[ok])
    return counts


# -- F3 ----------------------------------------------------------------------

def apply_pairs_u16(counts: torch.Tensor, triples: torch.Tensor) -> torch.Tensor:
    """``counts.view(-1)[pair] += count`` for each uint16 row ``[pair lo16,
    pair hi16, count]``, in place; a pair may repeat. The pair reads as
    an int32: the padding row 0xFFFF/0xFFFF is -1, and it and any pair
    beyond the state go to no cell. The kernel stages a warp's 32
    triples by 16-byte loads, any alignment and length of ``triples``
    taken. Returns ``counts``."""
    index = wk.fast_index((counts, torch.int32, 2), (triples, torch.uint16, 2))
    if index is None:
        wk.check_tensor(counts, "counts", torch.int32, 2)
        wk.check_tensor(triples, "triples", torch.uint16, 2)
    if triples.shape[1] != 3:
        raise ValueError(f"triples must be (P, 3), got {tuple(triples.shape)}")
    if index is None:
        if not wk.on_cuda("apply_pairs_u16", counts, triples):
            return apply_pairs_u16_plain(counts, triples)
        index = counts.get_device()
    _, stream = wk.launch_context(index)
    _APPLY_PAIRS_U16(stream, counts.data_ptr(), counts.numel(),
                     triples.data_ptr(), triples.shape[0])
    return counts


def apply_pairs_u16_plain(counts, triples):
    t = triples.to(torch.int64)
    pair = t[:, 0] | (t[:, 1] << 16)
    pair = torch.where(pair >= 2 ** 31, pair - 2 ** 32, pair)  # as int32
    ok = (pair >= 0) & (pair < counts.numel())
    counts.view(-1).index_add_(0, pair[ok], t[ok, 2].to(torch.int32))
    return counts


# -- F2 ----------------------------------------------------------------------

def fused_step(counts: torch.Tensor, emit_ring: torch.Tensor,
               buf: torch.Tensor, used_mask: torch.Tensor, *, ppw: int,
               n: int, sel_cap: int, dump_row: int, fire_gate: bool,
               fire_pad: int, form: int = FORM_WORDS) -> torch.Tensor:
    """One batch's fused step, in place on ``counts`` and ``emit_ring``.

    ``buf`` is the int32 upload: ``FUSED_HDR`` header words — ``[0:2]``
    pane_lo, ``[2:4]`` pane_hi, ``[4:6]`` anchor (int64), ``[7]`` / ``[6]``
    the clear mask of ring columns 0-31 / 32-63, ``[8:8 + 64]`` window-end
    deltas vs pane_lo (``DELTA_SENTINEL`` unused) — then the pairs: with
    ``form`` ``FORM_WORDS`` pair words as for ``apply_pairs_u32``, with
    ``FORM_TRIPLES`` uint16 triples as for ``apply_pairs_u16`` (as many
    whole triples as the words after the header hold; a 2-byte tail is
    not read). The step applies the pairs, fires the ends
    among the first ``fire_pad`` delta slots (``window_counts``, then
    ``topn_select_append`` of the top ``n`` with ``sel_cap`` into
    ``emit_ring`` at ``anchor``) and purges the masked columns
    (``ring_columns``). ``fire_gate`` skips the fire when no slot is
    valid and the purge when the mask is empty. Returns ``emit_ring``."""
    index = wk.fast_index((counts, torch.int32, 2), (emit_ring, torch.int32, 2),
                          (buf, torch.int32, 1), (used_mask, torch.bool, 1))
    if index is None:
        wk.check_tensor(counts, "counts", torch.int32, 2)
        wk.check_tensor(emit_ring, "emit_ring", torch.int32, 2)
        wk.check_tensor(buf, "buf", torch.int32, 1)
        wk.check_tensor(used_mask, "used_mask", torch.bool, 1)
    rows, ring = counts.shape
    if ring > MAX_FUSED_RING:
        raise ValueError(f"fused_step: ring {ring} > {MAX_FUSED_RING}, beyond "
                         "the header's clear mask")
    if not 1 <= fire_pad <= MIN_FIRE_PAD:
        raise ValueError(f"fused_step: fire_pad {fire_pad} outside 1..{MIN_FIRE_PAD}")
    if buf.numel() < FUSED_HDR:
        raise ValueError("fused_step: buf is shorter than its header")
    if used_mask.numel() != rows:
        raise ValueError("fused_step: used_mask does not match counts")
    if emit_ring.shape[1] != 3 or emit_ring.shape[0] < 3:
        raise ValueError(
            f"emit_ring must be (row_cap + 2, 3), got {tuple(emit_ring.shape)}")
    if n < 1 or sel_cap < 1:
        raise ValueError("n and sel_cap must be >= 1")
    if form not in (FORM_WORDS, FORM_TRIPLES):
        raise ValueError(f"fused_step: form {form} is neither FORM_WORDS nor "
                         "FORM_TRIPLES")
    if index is None:
        if not wk.on_cuda("fused_step", counts, emit_ring, buf, used_mask):
            return fused_step_plain(counts, emit_ring, buf, used_mask,
                                    ppw=ppw, n=n, sel_cap=sel_cap,
                                    dump_row=dump_row, fire_gate=fire_gate,
                                    fire_pad=fire_pad, form=form)
        index = counts.get_device()
    global _params_words
    if _params_words is None:
        _params_words = -(-_lib().ff_params_bytes() // 8) * 2
    # scratch in one allocation, in int32 words: the parameter block, then
    # the window counts; the top-n's workspace is the step's own
    _held, base = wk.scratch(counts.device, _params_words + rows * fire_pad)
    err, stream = wk.launch_context(index)
    work = wk.select_workspace("fused_step", index, stream, rows, fire_pad)
    try:
        _FUSED_STEP(stream, counts.data_ptr(), rows, ring, buf.data_ptr(),
                    buf.numel(), used_mask.data_ptr(), int(ppw), int(n),
                    int(sel_cap), emit_ring.data_ptr(), emit_ring.shape[0],
                    emit_ring.shape[1], int(dump_row), int(bool(fire_gate)),
                    int(fire_pad), base, base + 4 * _params_words, *work, err,
                    int(form))
    except RuntimeError:
        wk.drop_workspace("fused_step", index, stream)
        raise
    return emit_ring


def decode_header(buf: torch.Tensor, ring: int, fire_pad: int):
    """(pane_lo, pane_hi, anchor, end_panes, w_valid, clear mask as a
    (ring,) bool, clear words non-zero) of a fused-step upload, read on
    the host (the plain version's decode)."""
    lo, hi, anchor = buf[:6].view(torch.int64).tolist()
    deltas = buf[8:8 + fire_pad].long()
    w_valid = deltas > DELTA_SENTINEL
    end_panes = torch.where(w_valid, lo + deltas,
                            torch.full_like(deltas, END_SENTINEL))
    words = int(buf[7]) & 0xFFFFFFFF | (int(buf[6]) & 0xFFFFFFFF) << 32
    clear = torch.tensor([(words >> j) & 1 == 1 for j in range(ring)],
                         dtype=torch.bool, device=buf.device)
    return lo, hi, anchor, end_panes, w_valid, clear, words != 0


def pair_triples(buf: torch.Tensor) -> torch.Tensor:
    """The whole uint16 triples behind a fused-step upload's header, as a
    ``(P, 3)`` view (``FORM_TRIPLES``)."""
    t = buf[FUSED_HDR:].view(torch.uint16)
    p = t.numel() // 3
    return t[:3 * p].view(p, 3)


def fused_step_plain(counts, emit_ring, buf, used_mask, *, ppw, n, sel_cap,
                     dump_row, fire_gate, fire_pad, form=FORM_WORDS):
    ring = counts.shape[1]
    if form == FORM_TRIPLES:
        apply_pairs_u16_plain(counts, pair_triples(buf))
    else:
        apply_pairs_u32_plain(counts, buf[FUSED_HDR:], dump_row)
    lo, hi, anchor, end_panes, w_valid, clear, any_clear = decode_header(
        buf, ring, fire_pad)
    if not fire_gate or bool(w_valid.any()):
        wc = wk.window_counts_plain(counts, end_panes, w_valid, lo, hi, ppw)
        wk.topn_select_append_plain(wc, used_mask, end_panes, w_valid, anchor,
                                    n, sel_cap, emit_ring)
    if not fire_gate or any_clear:
        ident = torch.arange(ring, dtype=torch.int32, device=counts.device)
        wk.ring_columns_plain(counts, counts, ident, ~clear)
    return emit_ring

"""Word-level n-gram LM as device-resident tables for the fused beam (port of
`speechless_tpu/lm/device_lm.py`).

* a **vocabulary character trie** as a dense ``(nodes, classes)`` int32 transition table
  (row 0 = root) with a per-node completed-word id;
* **per-order 2-choice (cuckoo) hash tables** keyed on word-id n-grams, holding log10
  probabilities and backoff weights. Every key sits at one of exactly two slots, so a
  lookup is two key gathers and one value gather.

The numpy builder is the JAX package's, so both packages hold identical arrays.
`DeviceWordLm.to(device)` moves them to tensors; `score_word_device` is Katz backoff as
torch gathers, equal to `lm.ngram.ArpaLanguageModel.score_word`. The uint32 slot hashes
are computed in int64, masked to 32 bits after every multiply.
"""
from dataclasses import dataclass, fields
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ngram import BOS, UNK, ArpaLanguageModel

# Mixing constants shared by the numpy builder and the tensor prober (uint32 arithmetic).
# Two independent sets: every key hashes to one slot per set (2-choice hashing).
_MIXES = ((2654435761, 40503, 2246822519),
          (3266489917, 668265263, 374761393))
EMPTY = np.int32(-1)
_UINT32 = 0xFFFFFFFF


@dataclass(frozen=True)
class DeviceWordLm:
    """Device word LM: numpy arrays after `build_device_word_lm`, tensors after `to`."""
    trie: object         # (nodes, classes) int32 char transitions, -1 = no edge
    node_word: object    # (nodes,) int32 word id completed at this node, -1 = none
    uni_logp: object     # (V,) f32 log10 P(w)
    uni_bo: object       # (V,) f32 log10 backoff(w)
    bi_k: object         # (S2, 2) int32 cuckoo keys (c, w), -1 = empty
    bi_logp: object      # (S2,) f32
    bi_bo: object        # (S2,) f32 log10 backoff(c, w)
    tri_k: object        # (S3, 3) int32 keys (c1, c2, w), -1 = empty
    tri_logp: object     # (S3,) f32
    max_probes: int
    bos_id: int
    unk_id: int
    space_index: int

    def arrays(self) -> Tuple:
        """The nine table arrays, in field order."""
        return tuple(getattr(self, f.name) for f in fields(self)[:9])

    def to(self, device) -> "DeviceWordLm":
        """A copy whose tables are tensors on ``device``."""
        moved = [torch.as_tensor(a).to(device) for a in self.arrays()]
        return DeviceWordLm(*moved, self.max_probes, self.bos_id, self.unk_id,
                            self.space_index)


def _mix(keys: Sequence[np.ndarray], size: int, side: int) -> np.ndarray:
    m = _MIXES[side]
    with np.errstate(over="ignore"):  # uint32 wraparound is the hash
        h = np.uint32(0)
        for key, mix in zip(keys, m):
            h = h ^ (np.asarray(key).astype(np.uint32) * np.uint32(mix))
    return (h % np.uint32(size)).astype(np.int64)


def _key_slot(key: np.ndarray, size: int, side: int) -> int:
    return int(_mix(list(key), size, side))


def _build_hash_table(keys: np.ndarray, values: List[np.ndarray]
                      ) -> Tuple[np.ndarray, List[np.ndarray], int]:
    """Cuckoo (2-choice) insert of (keys -> values) rows; returns (key table, value
    tables, probe count == 2). Table size = next power of two >= 2 * entries, doubling
    on an insertion cycle."""
    entries = len(keys)
    width = keys.shape[1] if entries else 2
    size = 1
    while size < max(2 * entries, 2):
        size *= 2
    while True:
        table_keys = np.full((size, width), EMPTY, np.int32)
        table_values = [np.zeros(size, np.float32) for _ in values]
        ok = True
        for row in range(entries):
            key = keys[row].copy()
            vals = [np.float32(v[row]) for v in values]
            side = 0
            for _ in range(64 + entries // 4):
                slot = _key_slot(key, size, side)
                if table_keys[slot, 0] == EMPTY:
                    table_keys[slot] = key
                    for t, v in zip(table_values, vals):
                        t[slot] = v
                    break
                # Evict the occupant; it must move to its alternate slot.
                old_key = table_keys[slot].copy()
                old_vals = [t[slot] for t in table_values]
                table_keys[slot] = key
                for t, v in zip(table_values, vals):
                    t[slot] = v
                key, vals = old_key, old_vals
                side = 1 if _key_slot(key, size, 0) == slot else 0
            else:
                ok = False
                break
        if ok:
            return table_keys, table_values, 2
        size *= 2


def build_device_word_lm(model: ArpaLanguageModel, alphabet: Sequence[str],
                         space_index: Optional[int] = None) -> DeviceWordLm:
    """Pack a loaded ARPA model (order <= 3) into tables.

    ``alphabet`` is the grapheme alphabet WITHOUT the blank. Vocabulary words with
    characters outside it are dropped (the decoder could never produce them)."""
    if model.order > 3:
        raise ValueError("device fusion supports n-gram order <= 3, got {}".format(
            model.order))
    alphabet = list(alphabet)
    if space_index is None:
        space_index = alphabet.index(" ")
    char_ids = {c: i for i, c in enumerate(alphabet)}

    # Word ids = the ARPA's unigram entries in sorted order (includes <s>, </s>, <unk>).
    unigrams = sorted(model._log_probs[0].keys())
    word_id = {gram[0]: i for i, gram in enumerate(unigrams)}
    vocab_size = len(unigrams)

    transitions: List[np.ndarray] = [np.full(len(alphabet), EMPTY, np.int32)]  # root
    node_word: List[int] = [-1]
    for word in sorted(model.vocabulary):
        if not word or any(c not in char_ids or c == " " for c in word):
            continue
        node = 0
        for c in word:
            nxt = transitions[node][char_ids[c]]
            if nxt == EMPTY:
                transitions.append(np.full(len(alphabet), EMPTY, np.int32))
                node_word.append(-1)
                nxt = len(transitions) - 1
                transitions[node][char_ids[c]] = nxt
            node = int(nxt)
        node_word[node] = word_id[word]

    uni_logp = np.full(vocab_size, -99.0, np.float32)
    uni_bo = np.zeros(vocab_size, np.float32)
    for gram, logp in model._log_probs[0].items():
        uni_logp[word_id[gram[0]]] = logp
    for gram, bo in model._backoffs[0].items():
        if len(gram) == 1:
            uni_bo[word_id[gram[0]]] = bo

    def ids(gram):
        return [word_id[w] for w in gram]

    bi_entries = [(ids(g), p, model._backoffs[1].get(g, 0.0) if model.order >= 2 else 0.0)
                  for g, p in (model._log_probs[1].items() if model.order >= 2 else [])]
    bi_keys = np.asarray([e[0] for e in bi_entries], np.int32).reshape(-1, 2)
    bi_k, (bi_logp, bi_bo), bi_probes = _build_hash_table(
        bi_keys, [np.asarray([e[1] for e in bi_entries], np.float32),
                  np.asarray([e[2] for e in bi_entries], np.float32)])

    tri_entries = list(model._log_probs[2].items()) if model.order >= 3 else []
    tri_keys = np.asarray([ids(g) for g, _ in tri_entries], np.int32).reshape(-1, 3)
    tri_k, (tri_logp,), tri_probes = _build_hash_table(
        tri_keys, [np.asarray([p for _, p in tri_entries], np.float32)])

    return DeviceWordLm(
        trie=np.stack(transitions), node_word=np.asarray(node_word, np.int32),
        uni_logp=uni_logp, uni_bo=uni_bo,
        bi_k=bi_k, bi_logp=bi_logp, bi_bo=bi_bo,
        tri_k=tri_k, tri_logp=tri_logp,
        max_probes=max(bi_probes, tri_probes),
        bos_id=word_id[BOS], unk_id=word_id[UNK], space_index=space_index)


# -- lookups on tensors (vectors over beams) --------------------------------------------

def _slot(keys: Sequence[torch.Tensor], size: int, side: int) -> torch.Tensor:
    """uint32 ``(k1*m1 ^ k2*m2 [^ k3*m3]) % size`` in int64 arithmetic."""
    h = torch.zeros_like(keys[0], dtype=torch.int64)
    for key, mix in zip(keys, _MIXES[side]):
        h = h ^ (((key.to(torch.int64) & _UINT32) * mix) & _UINT32)
    return h % size


def _probe(table_keys: torch.Tensor, keys: Sequence[torch.Tensor]):
    """2-choice lookup: (matched slot, hit)."""
    size = table_keys.shape[0]
    slot_a = _slot(keys, size, 0)
    slot_b = _slot(keys, size, 1)
    match_a = torch.ones_like(keys[0], dtype=torch.bool)
    match_b = torch.ones_like(keys[0], dtype=torch.bool)
    for column, key in enumerate(keys):
        match_a = match_a & (table_keys[slot_a, column] == key)
        match_b = match_b & (table_keys[slot_b, column] == key)
    return torch.where(match_a, slot_a, slot_b), match_a | match_b


def probe2(lm: DeviceWordLm, k1: torch.Tensor, k2: torch.Tensor):
    """Bigram lookup: (log10 p, log10 backoff, hit); misses give 0."""
    idx, hit = _probe(lm.bi_k, (k1, k2))
    zero = lm.bi_logp.new_zeros(())
    return (torch.where(hit, lm.bi_logp[idx], zero), torch.where(hit, lm.bi_bo[idx], zero),
            hit)


def probe3(lm: DeviceWordLm, k1: torch.Tensor, k2: torch.Tensor, k3: torch.Tensor):
    """Trigram lookup: (log10 p, hit); misses give 0."""
    idx, hit = _probe(lm.tri_k, (k1, k2, k3))
    return torch.where(hit, lm.tri_logp[idx], lm.tri_logp.new_zeros(())), hit


def score_word_device(lm: DeviceWordLm, c1: torch.Tensor, c2: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """log10 P(w | c1, c2) with Katz backoff over int word-id vectors (context
    registers start as (BOS, BOS))."""
    uni = lm.uni_logp[w.long()]
    bo1 = lm.uni_bo[c2.long()]
    bi_logp, _, bi_hit = probe2(lm, c2, w)
    bi_score = torch.where(bi_hit, bi_logp, bo1 + uni)
    tri_logp, tri_hit = probe3(lm, c1, c2, w)
    _, bo2, _ = probe2(lm, c1, c2)  # missing context -> backoff 0
    return torch.where(tri_hit, tri_logp, bo2 + bi_score)

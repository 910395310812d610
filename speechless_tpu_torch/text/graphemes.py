"""Text <-> integer-grapheme codecs (CTC and ASG conventions): the port's own copy of
`speechless_tpu/text/graphemes.py`, kept so that a change to the JAX package never
reaches the port (`tests/test_torch_text.py` holds the two equal).

Semantics mirror the reference codec (the original speechless `grapheme_enconding.py`):

* characters are encoded to their index in ``allowed_characters``;
* batches are encoded into a ``-1``-padded ``int32`` matrix;
* CTC: one extra *blank* grapheme placed at the **last** index (TF convention);
* ASG: two extra repetition graphemes ``twice``/``thrice``; >3-fold repetition is an error;
* decoding optionally merges adjacent repeats first, then maps graphemes to characters
  (blank -> "", ASG twice/thrice -> 1/2 copies of the previous character).

The implementation here is vectorized (numpy) rather than per-character Python loops, since
it sits on the hot eval path when decoding large test sets.
"""
from typing import List, Optional, Sequence

import numpy as np


class GraphemeCodec:
    """Base codec over a fixed character inventory plus ``special_count`` trailing specials."""

    def __init__(self, allowed_characters: List[str], special_count: int):
        self.allowed_characters = list(allowed_characters)
        self.allowed_character_count = len(self.allowed_characters)
        self.grapheme_set_size = self.allowed_character_count + special_count
        self._index_by_char = {c: i for i, c in enumerate(self.allowed_characters)}
        # Fast vectorized char->index table over the BMP codepoints we may see.
        codes = np.array([ord(c) for c in self.allowed_characters], dtype=np.int64)
        self._max_code = int(codes.max()) if len(codes) else 0
        self._code_table = np.full(self._max_code + 1, -1, dtype=np.int32)
        self._code_table[codes] = np.arange(self.allowed_character_count, dtype=np.int32)

    # -- encoding ---------------------------------------------------------

    def encode_character(self, char: str) -> int:
        try:
            return self._index_by_char[char]
        except KeyError:
            raise ValueError("Unexpected char: '{}'".format(char))

    def _encode_characters(self, label: str) -> np.ndarray:
        """Vectorized per-character encoding; raises ValueError on unknown characters."""
        codes = np.frombuffer(label.encode("utf-32-le"), dtype=np.uint32).astype(np.int64)
        bad = codes > self._max_code
        if bad.any():
            raise ValueError("Unexpected char: '{}'".format(label[int(np.argmax(bad))]))
        graphemes = self._code_table[codes]
        if (graphemes < 0).any():
            raise ValueError("Unexpected char: '{}'".format(label[int(np.argmax(graphemes < 0))]))
        return graphemes

    def encode(self, label: str) -> List[int]:
        raise NotImplementedError

    def encode_label_batch(self, labels: Sequence[str]) -> np.ndarray:
        """Encode labels into a ``(batch, max_len)`` int32 matrix padded with ``-1``."""
        encoded = [self.encode(label) for label in labels]
        max_len = max((len(e) for e in encoded), default=0)
        batch = -np.ones((len(labels), max_len), dtype=np.int32)
        for row, graphemes in zip(batch, encoded):
            row[: len(graphemes)] = graphemes
        return batch

    # -- decoding ---------------------------------------------------------

    def decode_grapheme(self, grapheme: int, previous_grapheme: Optional[int]) -> str:
        raise NotImplementedError

    def decode_graphemes(self, graphemes: Sequence[int], merge_repeated: bool = True) -> str:
        graphemes = list(graphemes)
        if merge_repeated:
            graphemes = [g for i, g in enumerate(graphemes) if i == 0 or g != graphemes[i - 1]]
        return "".join(
            self.decode_grapheme(g, previous_grapheme=graphemes[i - 1] if i > 0 else None)
            for i, g in enumerate(graphemes))

    def decode_grapheme_batch(self, grapheme_batch: np.ndarray, prediction_lengths: Sequence[int],
                              merge_repeated: bool = True) -> List[str]:
        """Decode a ``(batch, time)`` grapheme matrix, truncating row ``i`` at ``prediction_lengths[i]``."""
        grapheme_batch = np.asarray(grapheme_batch)
        return [self.decode_graphemes(grapheme_batch[i, : prediction_lengths[i]],
                                      merge_repeated=merge_repeated)
                for i in range(grapheme_batch.shape[0])]

    def decode_prediction_batch(self, prediction_batch: np.ndarray,
                                prediction_lengths: Sequence[int]) -> List[str]:
        """Greedy-decode a ``(batch, time, grapheme)`` probability/logit batch."""
        return self.decode_grapheme_batch(np.argmax(np.asarray(prediction_batch), axis=2),
                                          prediction_lengths)


class CtcGraphemeCodec(GraphemeCodec):
    """CTC codec: blank is the **last** grapheme index (TF ``ctc_loss`` convention,
    the original speechless `grapheme_enconding.py:121-137`)."""

    def __init__(self, allowed_characters: List[str]):
        super().__init__(allowed_characters, special_count=1)
        self.ctc_blank = self.grapheme_set_size - 1

    def encode(self, label: str) -> List[int]:
        return self._encode_characters(label).tolist()

    def decode_grapheme(self, grapheme: int, previous_grapheme: Optional[int]) -> str:
        if 0 <= grapheme < self.allowed_character_count:
            return self.allowed_characters[grapheme]
        if grapheme == self.ctc_blank:
            return ""
        raise ValueError("Unexpected grapheme: '{}'".format(grapheme))


class AsgGraphemeCodec(GraphemeCodec):
    """ASG codec with ``twice``/``thrice`` repetition graphemes
    (the original speechless `grapheme_enconding.py:64-118`)."""

    def __init__(self, allowed_characters: List[str]):
        super().__init__(allowed_characters, special_count=2)
        self.asg_twice = self.grapheme_set_size - 2
        self.asg_thrice = self.grapheme_set_size - 1

    def encode(self, label: str) -> List[int]:
        naive = self._encode_characters(label)
        if naive.size == 0:
            return []
        # Vectorized run-length encoding.
        change = np.flatnonzero(np.diff(naive) != 0)
        starts = np.concatenate(([0], change + 1))
        run_lengths = np.diff(np.concatenate((starts, [naive.size])))
        out: List[int] = []
        for start, run in zip(starts, run_lengths):
            run = int(run)
            out.append(int(naive[start]))
            if run == 1:
                continue
            if run == 2:
                out.append(self.asg_twice)
            elif run == 3:
                out.append(self.asg_thrice)
            else:
                raise ValueError(
                    "{}-fold repetition found, ASG only supports up to 3-fold.".format(run))
        return out

    def decode_grapheme(self, grapheme: int, previous_grapheme: Optional[int]) -> str:
        if 0 <= grapheme < self.allowed_character_count:
            return self.allowed_characters[grapheme]
        # Repetition graphemes are only meaningful after a plain character; model outputs
        # can emit them anywhere (e.g. untrained argmax), so degrade to "" instead of
        # crashing on a leading/stacked special.
        valid_previous = (previous_grapheme is not None and
                          0 <= previous_grapheme < self.allowed_character_count)
        if grapheme == self.asg_twice:
            return self.allowed_characters[previous_grapheme] if valid_previous else ""
        if grapheme == self.asg_thrice:
            return self.allowed_characters[previous_grapheme] * 2 if valid_previous else ""
        raise ValueError("Unexpected grapheme: '{}'".format(grapheme))


# Backwards-compatible aliases matching the reference class names.
CtcGraphemeEncoding = CtcGraphemeCodec
AsgGraphemeEncoding = AsgGraphemeCodec

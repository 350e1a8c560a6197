"""CLIP byte-level BPE tokenizer (the text tower's input path).

Counterpart of ``interactive_vit_tpu/models/clip_bpe.py``, kept as this
package's own copy. Text is cleaned (html-unescaped twice, whitespace
collapsed, lower-cased), split into word / number / punctuation pieces,
each piece's UTF-8 bytes mapped through a reversible byte -> printable
character table, its last symbol tagged with the end-of-word marker, and
adjacent symbol pairs merged greedily in ranked order until no ranked
pair is left.

The ranked merge table ships with real CLIP checkpoints
(``bpe_simple_vocab_16e6.txt.gz``); ``load_merges`` reads one (plain or
gzip), and with it the ids are the published vocabulary's. Without merges
(``default_tokenizer``) the tokenizer is pure byte-level, what BPE does
when no merge rule applies: a vocabulary of 256 + 256 + 2 entries.

The JAX module splits with the ``regex`` package's pattern
``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|
[^\\s\\p{L}\\p{N}]+``; ``_pieces`` is the same leftmost-first scan written
over ``unicodedata``'s categories, so the port needs no package beyond the
standard library and numpy.
"""

from __future__ import annotations

import functools
import gzip
import html
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable unicode char table.

    Printable ASCII and the two Latin-1 printable ranges map to themselves;
    the other 68 byte values are moved past U+0100, so every byte has a
    visible, non-whitespace stand-in."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    table = {b: chr(b) for b in keep}
    bump = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(0x100 + bump)
            bump += 1
    return table


def _pairs(word: Sequence[str]) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _is_letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def _is_other(c: str) -> bool:
    """A character of the pattern's last class, ``[^\\s\\p{L}\\p{N}]``
    under ``regex.IGNORECASE``: that class also leaves out a character
    whose case variants are letters (U+0345, which folds to iota), so such
    a character is in no class and is skipped, as in the JAX module."""
    return not (c.isspace() or _is_number(c)
                or any(len(v) == 1 and _is_letter(v)
                       for v in (c, c.lower(), c.upper(), c.casefold())))


def _pieces(text: str) -> List[str]:
    """The pieces of cleaned ``text``: at each position the first of these
    that matches, else the position is skipped (whitespace): a special
    token, a contraction, a run of letters, one number character, a run of
    ``_is_other`` characters."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        head = next((t for t in (SOT, EOT) + _CONTRACTIONS
                     if text.startswith(t, i)), None)
        if head is not None:
            j = i + len(head)
        elif _is_letter(c):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(c):
            j = i + 1
        elif _is_other(c):
            j = i + 1
            while j < n and _is_other(text[j]):
                j += 1
        else:
            i += 1
            continue
        out.append(text[i:j])
        i = j
    return out


def load_merges(path: str, limit: Optional[int] = None
                ) -> List[Tuple[str, str]]:
    """Read a ranked merges file (``a b`` a line; gzip or plain text).

    The published CLIP file has a version header line and trailing junk:
    with ``limit`` None the first 49152 - 256 - 2 merges after the header
    are kept, so the vocabulary comes to the published 49408."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        lines = f.read().split("\n")
    if lines and (lines[0].startswith("#")
                  or lines[0].strip().count(" ") != 1):
        lines = lines[1:]  # version header
    stop = limit if limit is not None else 49152 - 256 - 2
    merges = []
    for ln in lines[:stop]:
        parts = ln.split()
        if len(parts) == 2:
            merges.append((parts[0], parts[1]))
    return merges


class ClipTokenizer:
    """Byte-level BPE with CLIP's vocabulary: byte symbols, the same
    tagged ``</w>``, one token a merge rule, then the two specials (so
    with the real merges the ids are the published 49408-entry
    vocabulary's)."""

    def __init__(self, merges: Optional[Iterable[Tuple[str, str]]] = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        merges = list(merges or [])
        symbols = list(bytes_to_unicode().values())
        vocab = symbols + [s + "</w>" for s in symbols]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT, EOT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.sot_id = self.encoder[SOT]
        self.eot_id = self.encoder[EOT]
        self._cache: Dict[str, List[str]] = {SOT: [SOT], EOT: [EOT]}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _bpe(self, piece: str) -> List[str]:
        """Greedy ranked merging of one piece (already byte-mapped)."""
        if piece in self._cache:
            return self._cache[piece]
        word: Tuple[str, ...] = tuple(piece[:-1]) + (piece[-1] + "</w>",)
        while len(word) > 1:
            ranked = [(self.bpe_ranks[p], p) for p in _pairs(word)
                      if p in self.bpe_ranks]
            if not ranked:
                break
            _, (a, b) = min(ranked)
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = list(word)
        self._cache[piece] = out
        return out

    def _clean(self, text: str) -> str:
        # CLIP runs ftfy.fix_text, a double html.unescape, a whitespace
        # collapse and lower-casing; fix_text only where ftfy is installed
        # (the identity on well-formed text such as prompts)
        try:
            import ftfy

            text = ftfy.fix_text(text)
        except ImportError:
            pass
        text = html.unescape(html.unescape(text))
        return " ".join(text.split()).strip().lower()

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in _pieces(self._clean(text)):
            if piece in (SOT, EOT):
                ids.append(self.encoder[piece])
                continue
            mapped = "".join(self.byte_encoder[b]
                             for b in piece.encode("utf-8"))
            ids.extend(self.encoder[tok] for tok in self._bpe(mapped))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids
                       if i not in (self.sot_id, self.eot_id))
        raw = bytes(self.byte_decoder[c] for c in text)
        return (raw.decode("utf-8", errors="replace")
                .replace("</w>", " ").strip())

    def batch(self, prompts: Sequence[str], context_length: int = 77
              ) -> np.ndarray:
        """``[P, context_length]`` int32: sot + tokens + eot, zero-padded.
        An over-long prompt is cut with eot kept in the last slot (CLIP's
        ``truncate=True``): the text tower pools at eot."""
        out = np.zeros((len(prompts), context_length), dtype=np.int32)
        for r, p in enumerate(prompts):
            ids = [self.sot_id] + self.encode(p) + [self.eot_id]
            if len(ids) > context_length:
                ids = ids[: context_length - 1] + [self.eot_id]
            out[r, : len(ids)] = ids
        return out


@functools.lru_cache(maxsize=1)
def default_tokenizer() -> ClipTokenizer:
    """The process-wide tokenizer: the byte vocabulary, no merges."""
    return ClipTokenizer()

"""Pure-Python BERT WordPiece tokenizer (copy of
`xggm_tpu/data/tokenizer.py`; the port imports nothing of the JAX package).

Behavioral port of the original BERT tokenization semantics the reference
vendors (reference src/lxrt/tokenization.py:72-388): basic tokenization
(lowercase, accent stripping, punctuation splitting, CJK spacing) followed by
greedy longest-match-first WordPiece with '##' continuation pieces.

Design difference vs the reference: tokenization runs in the *data pipeline*
(host side, amortized/cacheable), not inside the model forward pass as in
reference src/lxrt/entry.py:110-119 - per-batch host tokenization was one of
the reference's hot-loop bottlenecks (SURVEY.md §3, hot loop #2).
"""
from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

PAD_TOKEN = "[PAD]"
UNK_TOKEN = "[UNK]"
CLS_TOKEN = "[CLS]"
SEP_TOKEN = "[SEP]"
MASK_TOKEN = "[MASK]"
NEVER_SPLIT = (UNK_TOKEN, SEP_TOKEN, PAD_TOKEN, CLS_TOKEN, MASK_TOKEN)


def load_vocab(vocab_file: str) -> Dict[str, int]:
    """Load a BERT vocab.txt into an ordered token -> id dict."""
    vocab: Dict[str, int] = {}
    with open(vocab_file, "r", encoding="utf-8") as f:
        for idx, line in enumerate(f):
            token = line.rstrip("\n")
            if not token:
                continue
            vocab[token] = idx
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alphanumeric ranges count as punctuation (matches BERT, which
    # treats characters like '$' and '`' as punctuation despite Unicode class).
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class BasicTokenizer:
    """Whitespace/punctuation/accent/CJK normalization pass.

    Tokens in `never_split` (the BERT special tokens) pass through verbatim:
    no lowercasing, accent stripping, or punctuation splitting (reference
    src/lxrt/tokenization.py:174-224)."""

    def __init__(self, do_lower_case: bool = True,
                 never_split: Sequence[str] = NEVER_SPLIT):
        self.do_lower_case = do_lower_case
        self.never_split = frozenset(never_split)

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._space_cjk(text)
        tokens: List[str] = []
        for tok in text.strip().split():
            if tok in self.never_split:
                tokens.append(tok)
                continue
            if self.do_lower_case:
                tok = self._strip_accents(tok.lower())
            tokens.extend(self._split_punct(tok))
        return [t for t in " ".join(tokens).strip().split() if t]

    @staticmethod
    def _clean(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _space_cjk(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(
            ch for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    @staticmethod
    def _split_punct(tok: str) -> List[str]:
        pieces: List[List[str]] = []
        start_new = True
        for ch in tok:
            if _is_punctuation(ch):
                pieces.append([ch])
                start_new = True
            else:
                if start_new:
                    pieces.append([])
                    start_new = False
                pieces[-1].append(ch)
        return ["".join(p) for p in pieces]


class WordpieceTokenizer:
    """Greedy longest-match-first WordPiece segmentation."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = UNK_TOKEN,
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word

    def tokenize(self, token: str) -> List[str]:
        if len(token) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        n = len(token)
        while start < n:
            end = n
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces


class BertTokenizer:
    """End-to-end tokenizer: text -> WordPiece ids."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True):
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.basic = BasicTokenizer(do_lower_case=do_lower_case)
        self.wordpiece = WordpieceTokenizer(vocab)

    @classmethod
    def from_file(cls, vocab_file: str, do_lower_case: bool = True) -> "BertTokenizer":
        return cls(load_vocab(vocab_file), do_lower_case=do_lower_case)

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(tok))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        unk = self.vocab[UNK_TOKEN]
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.ids_to_tokens[i] for i in ids]

    def encode(self, text: str, max_seq_length: int) -> Tuple[List[int], List[int], List[int]]:
        """[CLS] tokens[:max-2] [SEP] + zero pad, as in reference
        src/lxrt/entry.py:37-72 (convert_sents_to_features)."""
        tokens = self.tokenize(text.strip())
        if len(tokens) > max_seq_length - 2:
            tokens = tokens[: max_seq_length - 2]
        tokens = [CLS_TOKEN] + tokens + [SEP_TOKEN]
        ids = self.convert_tokens_to_ids(tokens)
        mask = [1] * len(ids)
        seg = [0] * len(ids)
        pad = max_seq_length - len(ids)
        return ids + [0] * pad, mask + [0] * pad, seg + [0] * pad


def encode_batch(tokenizer: BertTokenizer, sents: Iterable[str],
                 max_seq_length: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized featurization of a batch of sentences -> fixed-shape int32."""
    ids, masks, segs = [], [], []
    for s in sents:
        i, m, g = tokenizer.encode(s, max_seq_length)
        ids.append(i)
        masks.append(m)
        segs.append(g)
    return (
        np.asarray(ids, dtype=np.int32),
        np.asarray(masks, dtype=np.int32),
        np.asarray(segs, dtype=np.int32),
    )


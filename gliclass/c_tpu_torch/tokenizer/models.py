"""Models of ``tokenizer.json``: a pre-tokenised word -> token ids."""

from __future__ import annotations

import heapq

# Words kept per model, as ``tokenizers``' BPE cache (cleared when full).
CACHE_CAPACITY = 10_000


class _Cached:
    """A per-word cache in front of ``_tokenize``. Threads may share it: a
    lost insertion only costs a recomputation."""

    def __init__(self):
        self._cache: dict[str, list[int]] = {}

    def tokenize(self, word: str) -> list[int]:
        ids = self._cache.get(word)
        if ids is None:
            ids = self._tokenize(word)
            if len(self._cache) >= CACHE_CAPACITY:
                self._cache.clear()
            self._cache[word] = ids
        return ids

    def _tokenize(self, word: str) -> list[int]:
        raise NotImplementedError


def _byte_pieces(text: str, vocab: dict[str, int]) -> list[int] | None:
    """``<0xNN>`` ids of the UTF-8 bytes of ``text``, or None when one is
    missing."""
    ids = [vocab.get(f"<0x{b:02X}>") for b in text.encode()]
    return None if None in ids else ids


class BPE(_Cached):
    def __init__(self, spec: dict, where: str):
        super().__init__()
        if spec.get("dropout") not in (None, 0, 0.0):
            raise NotImplementedError(f"BPE dropout {spec['dropout']} in {where}: the reader encodes "
                                      "deterministically and supports only dropout null")
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.unk_token = spec.get("unk_token")
        self.prefix = spec.get("continuing_subword_prefix")
        self.suffix = spec.get("end_of_word_suffix")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        cut = len(self.prefix) if self.prefix else 0
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(spec["merges"]):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b[cut:]])

    def _unk_id(self) -> int:
        if self.unk_token not in self.vocab:
            raise ValueError(f"BPE unk_token {self.unk_token!r} is not in the vocabulary")
        return self.vocab[self.unk_token]

    def _tokenize(self, word: str) -> list[int]:
        if not word:
            return []
        vocab = self.vocab
        if self.ignore_merges and word in vocab:
            return [vocab[word]]
        syms: list[int] = []
        unk = None  # the unknown token of the characters since the last known one
        last = len(word) - 1
        for i, c in enumerate(word):
            s = c
            if i and self.prefix is not None:
                s = self.prefix + s
            if i == last and self.suffix is not None:
                s = s + self.suffix
            tid = vocab.get(s)
            if tid is not None:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(tid)
                continue
            if self.byte_fallback:
                bids = _byte_pieces(s, vocab)
                if bids is not None:
                    syms.extend(bids)
                    continue
            if self.unk_token is not None:
                if unk is not None and not self.fuse_unk:
                    syms.append(unk)
                    unk = None
                if unk is None:
                    unk = self._unk_id()
        if unk is not None:
            syms.append(unk)
        return self._merge(syms)

    def _merge(self, syms: list[int]) -> list[int]:
        """``Word::merge_all``: merge the pair of least rank, leftmost first,
        until none is left."""
        n = len(syms)
        if n < 2:
            return syms
        merges = self.merges
        nxt = list(range(1, n)) + [-1]
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = merges.get((syms[i], syms[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] == -1:
                continue
            right = nxt[pos]
            m = merges.get((syms[pos], syms[right]))
            if m is None or m[1] != new_id:
                continue
            syms[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] != -1:
                prv[nxt[pos]] = pos
            if prv[pos] != -1:
                m = merges.get((syms[prv[pos]], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[pos], m[1]))
            if nxt[pos] != -1:
                m = merges.get((new_id, syms[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [s for s, a in zip(syms, alive) if a]


class Unigram(_Cached):
    """Viterbi over the pieces' scores; characters no piece covers are the
    unknown piece (``min score - 10``), runs of them fused."""

    UNK_PENALTY = 10.0

    def __init__(self, spec: dict, where: str):
        super().__init__()
        self.pieces = [(p, float(s)) for p, s in spec["vocab"]]
        # A repeated piece maps to its last id, as tokenizers' map does.
        self.vocab: dict[str, int] = {p: i for i, (p, _) in enumerate(self.pieces)}
        self.max_len = max(map(len, self.vocab), default=0)
        self.unk_id = spec.get("unk_id")
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.min_score = min((s for _, s in self.pieces), default=0.0)

    def _best_path(self, word: str) -> list[str]:
        n = len(word)
        unk_score = self.min_score - self.UNK_PENALTY
        score = [0.0] * (n + 1)
        start: list[int | None] = [None] * (n + 1)
        tid = [0] * (n + 1)
        vocab, pieces = self.vocab, self.pieces
        for i in range(n):
            base = score[i]
            single = False
            # The pieces that start at i, shortest first (tokenizers' trie
            # walk gives them in this order).
            for j in range(i + 1, min(n, i + self.max_len) + 1):
                pid = vocab.get(word[i:j])
                if pid is not None:
                    cand = pieces[pid][1] + base
                    if start[j] is None or cand > score[j]:
                        score[j], start[j], tid[j] = cand, i, pid
                    if j == i + 1:
                        single = True
            if not single:
                cand = unk_score + base
                if start[i + 1] is None or cand > score[i + 1]:
                    if self.unk_id is None:
                        raise ValueError("Unigram model has no unk_id for an unknown character")
                    score[i + 1], start[i + 1], tid[i + 1] = cand, i, self.unk_id
        out: list[str] = []
        unk_run: list[str] = []
        end = n
        while end > 0:
            s = start[end]
            if self.unk_id is not None and tid[end] == self.unk_id:
                unk_run.append(word[s:end])
            else:
                if unk_run:
                    out.append("".join(reversed(unk_run)))
                    unk_run = []
                out.append(word[s:end])
            end = s
        if unk_run:
            out.append("".join(reversed(unk_run)))
        out.reverse()
        return out

    def _tokenize(self, word: str) -> list[int]:
        if not word:
            return []
        ids = []
        for p in self._best_path(word):
            pid = self.vocab.get(p)
            if pid is None:
                if self.byte_fallback:
                    bids = _byte_pieces(p, self.vocab)
                    if bids is not None:
                        ids.extend(bids)
                        continue
                if self.unk_id is None:
                    raise ValueError("Unigram model has no unk_id for an unknown piece")
                pid = self.unk_id
            ids.append(pid)
        return ids


class WordLevel(_Cached):
    def __init__(self, spec: dict, where: str):
        super().__init__()
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.unk_token = spec.get("unk_token")

    def _tokenize(self, word: str) -> list[int]:
        tid = self.vocab.get(word)
        if tid is None:
            if self.unk_token not in self.vocab:
                raise ValueError(f"WordLevel unk_token {self.unk_token!r} is not in the vocabulary")
            tid = self.vocab[self.unk_token]
        return [tid]


def from_spec(spec: dict, where: str):
    kind = spec.get("type")
    if kind == "BPE":
        return BPE(spec, where)
    if kind == "Unigram":
        return Unigram(spec, where)
    if kind == "WordLevel":
        return WordLevel(spec, where)
    raise NotImplementedError(f"model type {kind!r} in {where} is not supported by the port's reader")

"""ARPA -> kenlm "format version 5" PROBING and TRIE binary writers, and the
trie reader (port of ``rnntransducer_tpu/utils/kenlm_binary.py``, pure
Python, byte-equal output).

Counterpart of the reader in ``native/ngram_lm.cpp``, which the port's
``decode/ngram_lm.py`` binds: a dependency-free way to produce and consume
the kenlm binaries that the original recipe loads through a pyctcdecode
model directory, and a fixture generator for the tests (kenlm itself is not
a dependency).

The layout written here is the 64-bit little-endian probing layout:
sanity header, fixed-width params, per-order counts, murmur-hashed vocab
probing table, unigram ProbBackoff array, chained-hash middle/longest
probing tables, and '\0'-joined trailing vocabulary strings.

The quantized trie writer keeps the reference's two choices that differ
from kenlm's ``build_binary -q``, so the bytes stay equal to the JAX
package's: where an order holds patched interior n-grams, the lowest center
of its probability bins is pinned at ``KLOG_ZERO`` after equal-frequency
training (a genuine n-gram nearest to it then reads back at the skip
threshold), and every zero backoff, -0.0 included, is encoded as bin 1
("extension") where kenlm keeps -0.0 in bin 0.  This module's reader and
``native/ngram_lm.cpp`` read both consistently.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

MAGIC = b"mmap lm http://kheafield.com/code format version 5\n\x00"
_M64 = (1 << 64) - 1
_CHAIN_A = 8978948897894561157
_CHAIN_B = 17894857484156487943
DEFAULT_MULTIPLIER = 1.5


def murmur64a(data: bytes, seed: int = 0) -> int:
    """MurmurHash64A — kenlm's vocab word hash on x86-64."""
    m = 0xC6A4A7935BD1E995
    r = 47
    h = (seed ^ (len(data) * m)) & _M64
    n8 = len(data) & ~7
    for i in range(0, n8, 8):
        k = int.from_bytes(data[i:i + 8], "little")
        k = (k * m) & _M64
        k ^= k >> r
        k = (k * m) & _M64
        h ^= k
        h = (h * m) & _M64
    tail = data[n8:]
    if tail:
        h ^= int.from_bytes(tail, "little")
        h = (h * m) & _M64
    h ^= h >> r
    h = (h * m) & _M64
    h ^= h >> r
    return h


def chain_hash(ids: List[int]) -> int:
    """kenlm n-gram key: fold the ids right-to-left (extend-left order)."""
    h = ids[-1] & _M64
    for w in reversed(ids[:-1]):
        h = ((h * _CHAIN_A) ^ ((w + 1) * _CHAIN_B)) & _M64
    return h


def _buckets(entries: int, multiplier: float) -> int:
    # float32 on purpose: real kenlm (and native/ngram_lm.cpp KenlmBuckets)
    # computes (uint64)(multiplier * (float)entries) in SINGLE precision —
    # double math here would disagree by one slot once entries exceeds
    # float32's 2^23 integer spacing (~5.6M n-grams), misaligning every
    # table after the first oversized one.
    import numpy as np
    scaled = int(np.float32(multiplier) * np.float32(entries))
    return max(entries + 1, scaled)


def _place(table: List[Tuple[int, bytes]], buckets: int,
           entry_size: int) -> bytearray:
    """Linear-probing placement; key 0 marks an empty slot."""
    slots: List[bytes] = [b"\x00" * entry_size] * buckets
    used = [False] * buckets
    for key, payload in table:
        b = key % buckets
        while used[b]:
            b = (b + 1) % buckets
        used[b] = True
        slots[b] = struct.pack("<Q", key) + payload
    return bytearray(b"".join(slots))


def parse_arpa(text: str):
    """Minimal ARPA parse -> (order, counts, {n: [(words, prob, backoff)]})."""
    lines = iter(text.splitlines())
    counts: List[int] = []
    for line in lines:
        line = line.strip()
        if line.startswith("ngram "):
            counts.append(int(line.split("=")[1]))
        elif line.endswith("-grams:"):
            cur = int(line[1:line.index("-")])
            break
    else:
        raise ValueError("no n-gram sections in ARPA input")
    order = len(counts)
    grams: Dict[int, list] = {n: [] for n in range(1, order + 1)}
    for line in lines:
        line = line.strip()
        if not line:
            continue
        if line.startswith("\\"):
            if line.endswith("-grams:"):
                cur = int(line[1:line.index("-")])
            continue
        parts = line.split()
        prob = float(parts[0])
        words = parts[1:1 + cur]
        backoff = float(parts[1 + cur]) if len(parts) > 1 + cur else 0.0
        grams[cur].append((words, prob, backoff))
    return order, counts, grams


def write_probing_binary(arpa_text: str, out_path: str,
                         multiplier: float = DEFAULT_MULTIPLIER) -> None:
    order, counts, grams = parse_arpa(arpa_text)
    if [len(grams[n]) for n in range(1, order + 1)] != counts:
        raise ValueError("ARPA counts header disagrees with section sizes")

    # ids: <unk> is always 0; the rest in unigram-section order (kenlm's
    # insertion order while reading the ARPA)
    vocab: Dict[str, int] = {"<unk>": 0}
    for words, _, _ in grams[1]:
        vocab.setdefault(words[0], len(vocab))
    if len(vocab) != counts[0]:
        raise ValueError("ARPA unigram section must include <unk>")

    out = bytearray()
    out += MAGIC.ljust(56, b"\x00")
    out += struct.pack("<f4xdQ", 0.0, 1.0, _M64)
    out += struct.pack("<B3xfi B3xI", order, multiplier, 0, 1, 0)
    for c in counts:
        out += struct.pack("<Q", c)
    while len(out) % 8:
        out += b"\x00"

    # vocabulary probing table
    out += struct.pack("<Q", len(vocab))  # header: bound (lowest unused id)
    vtab = [(murmur64a(w.encode()), struct.pack("<I4x", i))
            for w, i in vocab.items()]
    out += _place(vtab, _buckets(counts[0], multiplier), 16)

    # unigram ProbBackoff array, indexed by id (one spare trailing slot)
    uni = bytearray(struct.pack("<2f", 0.0, 0.0)) * (counts[0] + 1)
    for words, prob, backoff in grams[1]:
        i = vocab[words[0]]
        uni[8 * i:8 * i + 8] = struct.pack("<2f", prob, backoff)
    out += uni

    # middle orders (key, prob, backoff), longest order (key, prob, pad)
    for n in range(2, order + 1):
        longest = n == order
        rows = []
        for words, prob, backoff in grams[n]:
            ids = [vocab.get(w, 0) for w in words]
            payload = (struct.pack("<f4x", prob) if longest
                       else struct.pack("<2f", prob, backoff))
            rows.append((chain_hash(ids), payload))
        out += _place(rows, _buckets(counts[n - 1], multiplier), 16)

    # trailing vocabulary strings in id order
    words_by_id = sorted(vocab, key=vocab.get)
    out += b"\x00".join(w.encode() for w in words_by_id) + b"\x00"

    with open(out_path, "wb") as f:
        f.write(bytes(out))


# ---------------------------------------------------------------------------
# TRIE format (kenlm model_type 2 unquantized / 3 quantized, non-bhiksha
# — the `build_binary [-q N -b M] trie` outputs; model_type 2 is the default
# `build_binary trie` output).  Layout per kenlm lm/{trie,search_trie,
# vocab}.hh:
#
#   header (same as probing, model_type=2)
#   SortedVocab   uint64 n_hashes (= counts[0]-1, <unk> excluded) +
#                 sorted murmur64a hashes; word id = 1 + sorted position
#   Unigram       (counts[0]+2) x { f32 prob; f32 backoff; u64 next }
#                 ("+1 in case unknown doesn't appear, +1 for final next"):
#                 children of word w live at level-2 records
#                 [uni[w].next, uni[w+1].next); uni[counts[0]].next is the
#                 final sentinel (= counts[1])
#   Middle[k]     8-byte DontBhiksha block, then (counts[k-1]+1) records of
#                 word(RequiredBits(counts[0])) | prob31 | backoff32 |
#                 next(RequiredBits(counts[k])) bits, LSB-first packed,
#                 + 8 guard bytes; record counts[k-1] holds the final next
#   Longest       (counts[order-1]+1) x word | prob31 bits + 8 guard bytes
#   strings       '\0'-joined words in id order
#
# where prob31 = float bits with the (always-set, probs <= 0) sign bit
# dropped, and the TRIE is REVERSED: the path for n-gram (w1..wn) is
# [wn, w_{n-1}, .., w1] — unigram level indexes the PREDICTED word and
# context words extend leftward, exactly kenlm's extend-left layout.
#
# The C++ reader (native/ngram_lm.cpp LoadKenlmTrie) is written against the
# same spec and additionally probes the vocab/bhiksha section sizes
# defensively (validated against the unigram/final-next invariants), so a
# real-kenlm layout deviation in those blocks fails loudly instead of
# mis-scoring.
# ---------------------------------------------------------------------------

KLOG_ZERO = -99.0


def _required_bits(max_value: int) -> int:
    """kenlm util::RequiredBits: bits to represent max_value itself."""
    if max_value == 0:
        return 0
    ret = 1
    while max_value >> 1:
        ret += 1
        max_value >>= 1
    return ret


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.bit = 0  # bits used in the last byte

    def write(self, value: int, bits: int) -> None:
        for _ in range(bits):
            if self.bit == 0:
                self.buf.append(0)
            if value & 1:
                self.buf[-1] |= 1 << self.bit
            value >>= 1
            self.bit = (self.bit + 1) % 8

    def pad_to(self, total_bytes: int) -> bytes:
        out = bytes(self.buf)
        return out + b"\x00" * (total_bytes - len(out))


def _prob31(prob: float) -> int:
    """Non-positive float -> 31 bits (sign dropped; kenlm
    WriteNonPositiveFloat31)."""
    return struct.unpack("<I", struct.pack("<f", prob))[0] & 0x7FFFFFFF


def _f32_bits(x: float) -> int:
    return struct.unpack("<I", struct.pack("<f", x))[0]


def _build_trie(order, counts, grams, vocab):
    """Reversed-trie node tables.  Returns (levels, new_counts): levels[k]
    (k=2..order) is a list of (word, prob, backoff, next_begin) in global
    order; unigram level is (prob, backoff, next_begin) indexed by id.
    Missing interior nodes (ARPA without suffix closure) are patched in
    with prob=KLOG_ZERO like kenlm's FixSRIBug."""
    # children[k][parent_path (reversed, tuple)] = {word: (prob, backoff)}
    children: Dict[int, Dict[tuple, dict]] = {k: {} for k in range(2, order + 1)}
    uni_pb = {}
    for words, prob, backoff in grams[1]:
        uni_pb[vocab[words[0]]] = (prob, backoff)

    def ensure_path(rev_path):
        """Make every interior node of rev_path exist (patched if absent)."""
        for d in range(2, len(rev_path)):
            parent, w = tuple(rev_path[:d - 1]), rev_path[d - 1]
            children[d].setdefault(parent, {}).setdefault(
                w, (KLOG_ZERO, 0.0))

    for n in range(2, order + 1):
        for words, prob, backoff in grams[n]:
            ids = [vocab.get(w, 0) for w in words]
            rev = tuple(reversed(ids))          # [wn, .., w1]
            ensure_path(rev)
            children[n].setdefault(rev[:-1], {})[rev[-1]] = (prob, backoff)

    # assign global indices level by level (parents in global order,
    # children sorted by word id)
    paths = {1: [(w,) for w in range(counts[0])]}
    levels: Dict[int, list] = {}
    new_counts = [counts[0]]
    for k in range(2, order + 1):
        rows = []
        path_list = []
        for parent in paths[k - 1]:
            kids = children[k].get(parent, {})
            for w in sorted(kids):
                prob, backoff = kids[w]
                rows.append([w, prob, backoff, 0])
                path_list.append(parent + (w,))
        levels[k] = rows
        paths[k] = path_list
        new_counts.append(len(rows))

    # next pointers: node i's children occupy a contiguous run in level k+1
    for k in range(1, order):
        nxt = levels.get(k + 1, [])
        # map parent path -> [begin, end) by sweeping nxt in order
        begin_of = {}
        for i, path in enumerate(paths[k + 1]):
            begin_of.setdefault(path[:-1], i)
        run = 0
        if k == 1:
            uni_next = []
            for w in range(counts[0]):
                b = begin_of.get((w,), run)
                uni_next.append(b)
                kids = children.get(2, {}).get((w,), {})
                run = b + len(kids)
            uni_next.append(len(nxt))           # final sentinel
            levels.setdefault("uni_next", uni_next)
        else:
            for i, path in enumerate(paths[k]):
                b = begin_of.get(path, run)
                levels[k][i][3] = b
                kids = children.get(k + 1, {}).get(path, {})
                run = b + len(kids)
    return levels, new_counts, uni_pb


# --------------------------- quantization (model_type 3: QUANT_TRIE) ----
# kenlm SeparatelyQuantize (lm/quantize.hh): middle/longest probs and
# backoffs store BIN INDICES into per-order float tables; the unigram
# stays full f32.  Section layout (between the vocab hashes and the
# unigram): 8 bytes { version=2, prob_bits, backoff_bits, 5 pad }, then
# per middle order a prob table (2^pb f32) + backoff table (2^bb f32),
# then the longest order's prob table.  Backoff table slots 0/1 are
# reserved (-0.0 "no extension" / 0.0 "extension"); trained bins start at
# index 2.  Middle records become word | backoff_idx | prob_idx | next
# (backoff in the LOW bits, kenlm MiddlePointer::Write); longest records
# word | prob_idx.  Bins are trained equal-frequency per order.

QUANT_VERSION = 2


def _train_bins(values, n_bins: int) -> List[float]:
    """Equal-frequency bin centers (kenlm MakeBins style): sorted values
    split into n_bins runs, center = run mean.  Distinct values <= n_bins
    => every value is its own center (lossless)."""
    vals = sorted(values)
    if not vals:
        return [0.0] * n_bins
    uniq = sorted(set(vals))
    if len(uniq) <= n_bins:
        return uniq + [uniq[-1]] * (n_bins - len(uniq))
    centers = []
    n = len(vals)
    for i in range(n_bins):
        lo, hi = n * i // n_bins, n * (i + 1) // n_bins
        run = vals[lo:max(hi, lo + 1)]
        centers.append(sum(run) / len(run))
    return centers


def _encode_to_bins(value: float, centers: List[float], lo: int = 0) -> int:
    """Index of the nearest center (>= lo)."""
    import bisect
    i = bisect.bisect_left(centers, value, lo)
    best, best_d = lo, float("inf")
    for j in (i - 1, i, i + 1):
        if lo <= j < len(centers):
            d = abs(centers[j] - value)
            if d < best_d:
                best, best_d = j, d
    return best


def write_trie_binary(arpa_text: str, out_path: str,
                      quant_bits=None) -> None:
    """ARPA -> kenlm TRIE binary.  ``quant_bits=None``: model_type 2
    (unquantized, non-bhiksha, the default `build_binary trie` output);
    ``quant_bits=(prob_bits, backoff_bits)``: model_type 3 (QUANT_TRIE,
    `build_binary -q P -b B trie`) per the section spec above."""
    order, counts, grams = parse_arpa(arpa_text)
    if [len(grams[n]) for n in range(1, order + 1)] != counts:
        raise ValueError("ARPA counts header disagrees with section sizes")
    if order < 2:
        raise ValueError("TRIE layout needs order >= 2")
    if quant_bits is not None:
        pb, bb = quant_bits
        if not (1 <= pb <= 25 and 2 <= bb <= 25):
            raise ValueError("quant bits must be 1<=prob<=25, 2<=backoff<=25")

    # SortedVocab ids: <unk>=0, then sorted by murmur hash
    words = {w for ws, _, _ in grams[1] for w in ws}
    if "<unk>" not in words:
        raise ValueError("ARPA unigram section must include <unk>")
    hashed = sorted((murmur64a(w.encode()), w)
                    for w in words if w != "<unk>")
    vocab: Dict[str, int] = {"<unk>": 0}
    for i, (_, w) in enumerate(hashed):
        vocab[w] = i + 1

    levels, new_counts, uni_pb = _build_trie(order, counts, grams, vocab)

    model_type = 2 if quant_bits is None else 3
    out = bytearray()
    out += MAGIC.ljust(56, b"\x00")
    out += struct.pack("<f4xdQ", 0.0, 1.0, _M64)
    out += struct.pack("<B3xfi B3xI", order, DEFAULT_MULTIPLIER,
                       model_type, 1, 1)
    for c in new_counts:
        out += struct.pack("<Q", c)
    while len(out) % 8:
        out += b"\x00"

    # SortedVocab: count then sorted hashes (<unk> excluded)
    out += struct.pack("<Q", len(hashed))
    for h, _ in hashed:
        out += struct.pack("<Q", h)

    # quantization tables (QUANT_TRIE only; spec above)
    quant_tables = {}
    if quant_bits is not None:
        pb, bb = quant_bits
        out += struct.pack("<3B5x", QUANT_VERSION, pb, bb)
        for k in range(2, order + 1):
            probs = [row[1] for row in levels[k]]
            pt = _train_bins(probs, 1 << pb)
            if any(p <= KLOG_ZERO + 1 for p in probs):
                # patched interior nodes must stay below the scorer's
                # skip threshold: pin the lowest center to KLOG_ZERO
                pt[0] = KLOG_ZERO
            bt = None
            if k < order:
                nz = [row[2] for row in levels[k] if row[2] != 0.0]
                bt = [-0.0, 0.0] + _train_bins(nz, (1 << bb) - 2)
            quant_tables[k] = (pt, bt)
            for v in pt:
                out += struct.pack("<f", v)
            if bt is not None:
                for v in bt:
                    out += struct.pack("<f", v)

    # unigrams
    uni_next = levels["uni_next"]
    for w in range(counts[0]):
        prob, backoff = uni_pb.get(w, (KLOG_ZERO, 0.0))
        out += struct.pack("<2fQ", prob, backoff, uni_next[w])
    out += struct.pack("<2fQ", 0.0, 0.0, uni_next[counts[0]])  # final next
    out += struct.pack("<2fQ", 0.0, 0.0, 0)                    # spare slot

    word_bits = _required_bits(counts[0])
    for k in range(2, order + 1):
        rows = levels[k]
        longest = k == order
        if quant_bits is not None:
            pb, bb = quant_bits
            prob_field = pb
            backoff_field = 0 if longest else bb
            pt, bt = quant_tables[k]
        else:
            prob_field = 31
            backoff_field = 0 if longest else 32
        if longest:
            total_bits = word_bits + prob_field
        else:
            next_bits = _required_bits(new_counts[k])
            total_bits = word_bits + backoff_field + prob_field + next_bits
            out += struct.pack("<Q", 0)         # DontBhiksha block
        bw = _BitWriter()
        for w, prob, backoff, nxt in rows:
            bw.write(w, word_bits)
            if quant_bits is not None:
                if not longest:
                    # backoff index sits in the LOW bits of the combined
                    # quant field (kenlm MiddlePointer::Write)
                    if backoff == 0.0:
                        bw.write(1, bb)         # reserved "extension" slot
                    else:
                        bw.write(_encode_to_bins(backoff, bt, 2), bb)
                bw.write(_encode_to_bins(prob, pt), pb)
            else:
                bw.write(_prob31(prob), 31)
                if not longest:
                    bw.write(_f32_bits(backoff), 32)
            if not longest:
                bw.write(nxt, next_bits)
        # final record: only the next field is meaningful
        if longest:
            bw.write(0, total_bits)
        else:
            bw.write(0, total_bits - next_bits)
            bw.write(new_counts[k], next_bits)
        nbytes = ((len(rows) + 1) * total_bits + 7) // 8 + 8  # +guard
        out += bw.pad_to(nbytes)

    words_by_id = sorted(vocab, key=vocab.get)
    out += b"\x00".join(w.encode() for w in words_by_id) + b"\x00"
    with open(out_path, "wb") as f:
        f.write(bytes(out))


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data

    def read(self, bit_off: int, bits: int) -> int:
        byte = bit_off >> 3
        word = int.from_bytes(self.data[byte:byte + 9], "little")
        return (word >> (bit_off & 7)) & ((1 << bits) - 1)


def read_trie_binary(path: str):
    """Parse a TRIE binary back to (order, counts, grams, vocab) — the
    pure-Python mirror of native/ngram_lm.cpp LoadKenlmTrie, used by
    scripts/convert_lm.py (trie -> ARPA) and as a cross-check in tests."""
    data = open(path, "rb").read()
    if data[:8] != b"mmap lm ":
        raise ValueError("not a kenlm binary")
    order, mult, model_type, has_vocab, _ = struct.unpack_from(
        "<B3xfi B3xI", data, 80)
    if model_type not in (2, 3):
        raise ValueError(f"model_type {model_type} is not TRIE(2) or "
                         "QUANT_TRIE(3)")
    if not has_vocab:
        raise ValueError("binary lacks trailing vocabulary strings")
    counts = list(struct.unpack_from(f"<{order}Q", data, 100))
    off = 100 + 8 * order
    off += (-off) % 8
    n_hashes, = struct.unpack_from("<Q", data, off)
    off += 8 + 8 * n_hashes

    quant_tables = None
    if model_type == 3:
        ver, pb, bb = struct.unpack_from("<3B", data, off)
        if ver != QUANT_VERSION or not (1 <= pb <= 25 and 2 <= bb <= 25):
            raise ValueError(
                f"unsupported quantization header (version {ver}, "
                f"prob_bits {pb}, backoff_bits {bb})")
        off += 8
        quant_tables = {}
        for k in range(2, order + 1):
            pt = list(struct.unpack_from(f"<{1 << pb}f", data, off))
            off += 4 * (1 << pb)
            bt = None
            if k < order:
                bt = list(struct.unpack_from(f"<{1 << bb}f", data, off))
                off += 4 * (1 << bb)
            quant_tables[k] = (pt, bt)

    uni = []
    for i in range(counts[0] + 2):
        uni.append(struct.unpack_from("<2fQ", data, off + 16 * i))
    off += 16 * (counts[0] + 2)

    word_bits = _required_bits(counts[0])
    br = _BitReader(data)
    levels = {}
    for k in range(2, order + 1):
        longest = k == order
        if quant_tables is not None:
            pt, bt = quant_tables[k]
            prob_field = pb
            backoff_field = 0 if longest else bb
        else:
            prob_field = 31
            backoff_field = 0 if longest else 32
        if longest:
            total_bits = word_bits + prob_field
        else:
            next_bits = _required_bits(counts[k])
            total_bits = (word_bits + backoff_field + prob_field
                          + next_bits)
            off += 8                             # DontBhiksha block
        rows = []
        base_bit = off * 8
        for i in range(counts[k - 1]):
            b = base_bit + i * total_bits
            w = br.read(b, word_bits)
            if quant_tables is not None:
                # quantized middle record: word | backoff_idx | prob_idx
                # | next (backoff in the low bits, spec above)
                if longest:
                    prob = pt[br.read(b + word_bits, pb)]
                    rows.append((w, prob, 0.0, None))
                else:
                    bo = bt[br.read(b + word_bits, bb)]
                    prob = pt[br.read(b + word_bits + bb, pb)]
                    nxt = br.read(b + word_bits + bb + pb, next_bits)
                    rows.append((w, prob, bo, nxt))
            else:
                p_bits = br.read(b + word_bits, 31)
                prob = struct.unpack("<f", struct.pack(
                    "<I", p_bits | 0x80000000))[0]
                if longest:
                    rows.append((w, prob, 0.0, None))
                else:
                    bo = struct.unpack("<f", struct.pack(
                        "<I", br.read(b + word_bits + 31, 32)))[0]
                    nxt = br.read(b + word_bits + 63, next_bits)
                    rows.append((w, prob, bo, nxt))
        if not longest:
            fin = br.read(base_bit + counts[k - 1] * total_bits
                          + total_bits - next_bits, next_bits)
            if fin != counts[k]:
                raise ValueError(
                    f"level {k} final next {fin} != count {counts[k]}")
        levels[k] = rows
        off += ((counts[k - 1] + 1) * total_bits + 7) // 8 + 8

    strings = data[off:].split(b"\x00")
    vocab_words = [s.decode() for s in strings[:counts[0]]]
    if len(vocab_words) != counts[0] or vocab_words[0] != "<unk>":
        raise ValueError("trailing vocabulary truncated or missing <unk>")

    # DFS the reversed trie back into natural-order n-grams
    grams: Dict[int, list] = {n: [] for n in range(1, order + 1)}
    for w in range(counts[0]):
        prob, backoff, _ = uni[w]
        grams[1].append(([vocab_words[w]], prob, backoff))

    def walk(level, begin, end, rev_path):
        # rev_path: trie path so far, unigram (predicted word) first; the
        # natural n-gram order is the path reversed
        for i in range(begin, end):
            w, prob, backoff, nxt = levels[level][i]
            tp = rev_path + [w]
            natural = [vocab_words[j] for j in tp[::-1]]
            grams[level].append((natural, prob, backoff))
            if level < order:
                if i + 1 < counts[level - 1]:
                    nxt_end = levels[level][i + 1][3]
                else:
                    nxt_end = counts[level]     # final sentinel
                walk(level + 1, nxt, nxt_end, tp)

    for w in range(counts[0]):
        walk(2, uni[w][2], uni[w + 1][2], [w])
    return order, counts, grams, {w: i for i, w in enumerate(vocab_words)}


def main() -> None:  # pragma: no cover - thin CLI
    import argparse

    p = argparse.ArgumentParser(
        description="Convert a text ARPA LM to a kenlm-probing binary")
    p.add_argument("arpa")
    p.add_argument("out")
    args = p.parse_args()
    with open(args.arpa) as f:
        write_probing_binary(f.read(), args.out)


if __name__ == "__main__":  # pragma: no cover
    main()

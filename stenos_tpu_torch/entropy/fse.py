"""FSE (tANS) encoder, clean-room from RFC 8878 §4.1: the port's copy of
the parts of stenos_tpu/entropy/fse.py that the sequence section encoder
(sequences.py) and the K6 prep (fse_kernel.prep_block) need. Host code on
small tables (<= 512 states, <= 53 symbols).
"""

import numpy as np


class BitWriter:
    """Little-endian bit accumulator; decoder reads the stream BACKWARD
    starting from the 1-terminator bit (RFC 8878 §3.1.1.3.2.1)."""

    def __init__(self):
        self.acc = 0
        self.nbits = 0
        self.out = bytearray()

    def add(self, value: int, nbits: int):
        self.acc |= (value & ((1 << nbits) - 1)) << self.nbits
        self.nbits += nbits
        while self.nbits >= 8:
            self.out.append(self.acc & 255)
            self.acc >>= 8
            self.nbits -= 8

    def close(self) -> bytes:
        self.add(1, 1)  # end marker
        if self.nbits:
            self.out.append(self.acc & ((1 << self.nbits) - 1))
            self.acc = 0
            self.nbits = 0
        return bytes(self.out)


def normalize_counts(counts: np.ndarray, table_log: int, total: int):
    """Normalize to sum 2^table_log, every present symbol >= 1 (we do not
    emit -1 probabilities — valid, slightly less optimal)."""
    counts = np.asarray(counts, np.int64)
    size = 1 << table_log
    present = counts > 0
    n_present = int(present.sum())
    assert n_present >= 1 and total > 0
    norm = np.zeros(len(counts), np.int64)
    if n_present == 1:
        norm[np.argmax(present)] = size
        return norm.astype(np.int32)
    scaled = counts * size // total
    norm = np.where(present, np.maximum(scaled, 1), 0)
    diff = size - int(norm.sum())
    if diff > 0:
        # distribute to the largest counts
        order = np.argsort(-counts, kind="stable")
        i = 0
        while diff > 0:
            s = order[i % n_present]
            norm[s] += 1
            diff -= 1
            i += 1
    while diff < 0:
        # take from symbols with the most slack (norm large vs share)
        slack = np.where(norm > 1, norm - counts * size / total, -1)
        s = int(np.argmax(slack))
        take = min(-diff, int(norm[s]) - 1)
        assert take > 0
        norm[s] -= take
        diff += take
    assert norm.sum() == size
    return norm.astype(np.int32)


def write_ncount(norm: np.ndarray, table_log: int, max_symbol: int) -> bytes:
    """Serialize the normalized count table (FSE_writeNCount semantics)."""
    bw = BitWriter()
    bw.add(table_log - 5, 4)
    size = 1 << table_log
    remaining = size + 1
    threshold = size
    nb_bits = table_log + 1
    s = 0
    previous0 = False
    while remaining > 1 and s <= max_symbol:
        if previous0:
            start = s
            while s <= max_symbol and norm[s] == 0:
                s += 1
            run = s - start
            while run >= 3:
                bw.add(3, 2)
                run -= 3
            bw.add(run, 2)
            if s > max_symbol:
                break
        count = int(norm[s])
        s += 1
        maxv = (2 * threshold - 1) - remaining
        remaining -= count if count >= 0 else 1
        value = count + 1  # -1 maps to 0
        if value >= threshold:
            value += maxv
        if value < maxv:
            bw.add(value, nb_bits - 1)
        else:
            bw.add(value, nb_bits)
        previous0 = count == 0
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1
    # NB: close() appends the end-marker bit; the ncount field is byte-aligned
    # on its own (the decoder tracks bit position), so only pad here.
    if bw.nbits:
        bw.out.append(bw.acc & ((1 << bw.nbits) - 1))
        bw.acc = 0
        bw.nbits = 0
    return bytes(bw.out)


def build_ctable(norm: np.ndarray, table_log: int):
    """FSE compression table from normalized counts.

    Returns (state_table (size,), sym_delta_nbbits (S,), sym_delta_find (S,),
    spread) following the standard tANS construction."""
    norm = np.asarray(norm, np.int64)
    size = 1 << table_log
    S = len(norm)
    n_low = int(np.sum(norm == -1))
    high_threshold = size - 1 - n_low
    spread = np.zeros(size, np.int32)
    # low-prob symbols at the end
    pos_end = size - 1
    for sym in range(S):
        if norm[sym] == -1:
            spread[pos_end] = sym
            pos_end -= 1
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    position = 0
    for sym in range(S):
        for _ in range(max(int(norm[sym]), 0)):
            spread[position] = sym
            position = (position + step) & mask
            while position > high_threshold:
                position = (position + step) & mask
    assert position == 0
    # cumulative start per symbol (in state-table order)
    cumul = np.zeros(S + 1, np.int64)
    for sym in range(S):
        cumul[sym + 1] = cumul[sym] + (1 if norm[sym] == -1 else
                                       max(int(norm[sym]), 0))
    state_table = np.zeros(size, np.int64)
    cc = cumul.copy()
    for u in range(size):
        sym = int(spread[u])
        state_table[cc[sym]] = size + u
        cc[sym] += 1
    delta_nb = np.zeros(S, np.int64)
    delta_fs = np.zeros(S, np.int64)
    total = 0
    for sym in range(S):
        c = int(norm[sym])
        if c in (-1, 1):
            delta_nb[sym] = (table_log << 16) - (1 << table_log)
            delta_fs[sym] = total - 1
            total += 1
        elif c == 0:
            delta_nb[sym] = ((table_log + 1) << 16) - (1 << table_log)
            delta_fs[sym] = total - 1
        else:
            max_bits_out = table_log - (c - 1).bit_length() + 1
            # highbit(c-1) = bit_length(c-1) - 1
            max_bits_out = table_log - ((c - 1).bit_length() - 1)
            min_state_plus = c << max_bits_out
            delta_nb[sym] = (max_bits_out << 16) - min_state_plus
            delta_fs[sym] = total - c
            total += c
    return state_table, delta_nb, delta_fs, spread


class FseEncoder:
    def __init__(self, norm, table_log):
        self.table_log = table_log
        self.state_table, self.dnb, self.dfs, _ = build_ctable(
            norm, table_log)
        self.value = 0

    def init_state(self, sym: int):
        nb_out = (int(self.dnb[sym]) + (1 << 15)) >> 16
        v = (nb_out << 16) - int(self.dnb[sym])
        self.value = int(self.state_table[(v >> nb_out) + int(self.dfs[sym])])

    def encode(self, bw: BitWriter, sym: int):
        nb = (self.value + int(self.dnb[sym])) >> 16
        bw.add(self.value, nb)
        self.value = int(
            self.state_table[(self.value >> nb) + int(self.dfs[sym])])

    def flush(self, bw: BitWriter):
        bw.add(self.value, self.table_log)

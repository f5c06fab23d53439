"""Edge cases of wc_words and segment_reduce that two test files run: the
card tests (tests/test_torch_cuda.py: each kernel against its plain version)
and the CPU tests (tests/test_torch_wordcount.py: each plain version against
the JAX program).  No JAX here, so the card tests can import it."""
import numpy as np

# csrc/wordcount.cu: wc_words' tile (kWordTile) and the halo before it (kHalo)
TILE, HALO = 8192, 256
# csrc/segment.cu: the values a block takes a sweep (kThreads x kGroups x 4)
BLOCK_SWEEP = 512 * 2 * 4

_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789", np.uint8)


def _words(rng, n, long_every=0):
    """n bytes of words of 1-12 letters (one in `long_every` of 64-300)
    separated by 1-3 spaces."""
    out = np.full(n, 32, np.uint8)
    i, k = 0, 0
    while i < n:
        ln = int(rng.integers(64, 300)) if long_every and k % long_every == 0 else int(rng.integers(1, 13))
        out[i: i + ln] = _LETTERS[rng.integers(0, _LETTERS.size, ln)][: n - i]
        i += ln + int(rng.integers(1, 4))
        k += 1
    return out


def _word_at(buf, start, end):
    """A word on [start, end) with whitespace on both sides."""
    buf[start - 1] = 32
    buf[start:end] = ord("w")
    if end < buf.size:
        buf[end] = 32


def wc_edge_buffers():
    """name -> a uint8 buffer of two to three wc_words tiles, whitespace
    normalised to 0x20."""
    rng = np.random.default_rng(31)
    out = {}
    b = _words(rng, 3 * TILE + 100)
    for edge in (TILE, 2 * TILE, 3 * TILE):
        _word_at(b, edge - 3, edge + 4)  # straddles the edge
    out["words straddling tile edges"] = b
    b = _words(rng, 3 * TILE + 100)
    _word_at(b, TILE - 5, TILE)  # its end is the last byte of tile 0
    _word_at(b, 2 * TILE - 3, 2 * TILE + 1)  # its end is the first byte of tile 2
    _word_at(b, 3 * TILE, 3 * TILE + 1)  # a one-byte word on the first byte of tile 3
    out["ends on the last and the first byte of a tile"] = b
    b = _words(rng, 3 * TILE + 100)
    _word_at(b, TILE - 600, TILE + 400)  # 1,000 bytes, past the halo
    _word_at(b, 2 * TILE - HALO - 1, 2 * TILE + 2)  # one byte longer than the halo before the edge
    _word_at(b, 3 * TILE - HALO, 3 * TILE + 2)  # exactly the halo before the edge
    out["words longer than the halo across tile edges"] = b
    out["words over 63 bytes"] = _words(rng, 2 * TILE + 1000, long_every=3)
    b = _words(rng, 2 * TILE + 7)
    b[-1] = ord("z")
    out["n not a multiple of 16, the last byte a word's"] = b
    out["one word of three tiles"] = np.full(3 * TILE - 5, ord("q"), np.uint8)
    return out


def wc_row_cases(buf):
    """(n_words, eb, base) to run on a buffer: the words found, eb below the
    end count, n_words above it, n_words 0, base near 2**32."""
    ws = buf == 32
    found = int(np.count_nonzero(~ws & np.concatenate([ws[1:], [True]])))
    n = buf.size
    return [(found, min(n, found + 37), 1000), (found, max(1, found // 3), 5),
            (found + 50, min(n, found + 100), 0), (0, min(n, 256), 9), (found, found or 1, 2**32 - 5)]


def true_deltas(buf, rows):
    ws = buf == 32
    ends = np.nonzero(~ws & np.concatenate([ws[1:], [True]]))[0]
    d = np.zeros(rows, np.int64)
    k = min(rows, ends.size)
    d[:k] = np.diff(np.concatenate([[-1], ends]))[:k]
    return d


def segment_edge_cases():
    """name -> (keys int64, values int32, n_keys): n of 1 and 3, one
    vector short of and past a block's sweep, work for a number of blocks
    that is not a multiple of the cluster size, keys negative (within one
    wrap and past it) and past n_keys."""
    rng = np.random.default_rng(47)
    out = {}
    for label, n, n_keys in (("n 1", 1, 5), ("n 3", 3, 5), ("one vector short of a block's sweep", BLOCK_SWEEP - 4, 1024),
                             ("one vector past a block's sweep", BLOCK_SWEEP + 4, 1024),
                             ("three blocks' sweeps and 5: one cluster", 3 * BLOCK_SWEEP + 5, 1024),
                             ("nine blocks' sweeps and 3: not a cluster's multiple", 9 * BLOCK_SWEEP + 3, 777)):
        keys = rng.integers(-2 * n_keys, 2 * n_keys, n)
        vals = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
        out[label] = (keys, vals, n_keys)
    return out

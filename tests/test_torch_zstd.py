"""PyTorch port: ``ops/host_zstd`` (the zstd decoder of ``csrc/host_zstd.cpp``,
which reads Orbax checkpoints where ``zstandard`` is absent) against the
``zstandard`` module: the bytes it compressed at levels −5, 1, 3 and 19, with
and without a content checksum and a content size, several frames back to
back, skippable frames, empty input and inputs from 1 byte to a few MB; and
the refusals: truncated or corrupt frames, a dictionary, a size past the
bound."""

import os

import numpy as np
import pytest
import zstandard

from twinvoice_tpu_torch.ops import host_zstd as Z


def inputs():
    rng = np.random.default_rng(0)
    words = [b"alpha", b"beta", b"gamma", b"delta", b'{"chunks":[2,3]}']
    return {
        "empty": b"",
        "one byte": b"a",
        "bytes 0-255": bytes(range(256)) * 3,
        "random 1000": rng.integers(0, 256, 1000, dtype=np.uint8).tobytes(),
        "text": b"hello world " * 1000,
        "float32 noise": rng.standard_normal(100_000).astype(np.float32).tobytes(),
        "ramp": (np.arange(300_000) % 251).astype(np.uint8).tobytes(),
        "2 bits a byte, 3 MB": rng.integers(0, 4, 3_000_000, dtype=np.uint8).tobytes(),
        "words": b" ".join(words[i] for i in rng.integers(0, 5, 200_000)),
    }


@pytest.mark.parametrize("level", [-5, 1, 3, 19])
def test_decompress_equals_zstandard(level):
    for name, data in inputs().items():
        if level == 19 and len(data) > 500_000:
            data = data[:500_000]  # level 19 on megabytes is slow to compress
        for checksum in (True, False):
            for size in (True, False):
                c = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                             write_content_size=size).compress(data)
                assert Z.decompress(c) == data, (name, checksum, size)


def test_streamed_frames_and_several_frames():
    """Frames without a content size made by the streaming API (several
    blocks, a window descriptor), several frames and skippable frames back
    to back, and empty input."""
    data = inputs()
    chunks = []
    for name in ("text", "float32 noise", "words"):
        co = zstandard.ZstdCompressor(level=3, write_checksum=True).compressobj()
        chunks.append(co.compress(data[name]) + co.flush())
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    joined = chunks[0] + skip + chunks[1] + chunks[2] + skip
    assert Z.decompress(joined) == data["text"] + data["float32 noise"] + data["words"]
    assert Z.decompress(b"") == b""
    assert Z.decompress(zstandard.ZstdCompressor().compress(b"")) == b""


def test_refusals():
    data = inputs()["words"][:200_000]
    c = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    for cut in (1, 3, 4, 5, 10, len(c) // 2, len(c) - 1):
        with pytest.raises(ValueError, match="zstd"):
            Z.decompress(c[:cut])
    bad = bytearray(c)
    bad[-1] ^= 0xFF  # the checksum
    with pytest.raises(ValueError, match="checksum"):
        Z.decompress(bytes(bad))
    with pytest.raises(ValueError, match="magic"):
        Z.decompress(b"\x00\x01\x02\x03" + c)
    rng = np.random.default_rng(1)
    for _ in range(200):  # corrupt bytes anywhere: an error, never a crash
        b = bytearray(c)
        b[int(rng.integers(4, len(b)))] ^= 1 << int(rng.integers(0, 8))
        try:
            Z.decompress(bytes(b))
        except ValueError:
            pass
    samples = [os.urandom(16) + b"common prefix of the samples %d" % i for i in range(400)]
    d = zstandard.train_dictionary(4096, samples)
    with pytest.raises(ValueError, match="dictionary"):
        Z.decompress(zstandard.ZstdCompressor(dict_data=d).compress(samples[0]))
    with pytest.raises(ValueError, match="bound"):
        Z.decompress(c, max_out=len(data) - 1)
    co = zstandard.ZstdCompressor(level=3).compressobj()  # no declared size: grows past it
    with pytest.raises(ValueError, match="bound"):
        Z.decompress(co.compress(data) + co.flush(), max_out=1000)


def test_xxh64_known_values():
    """XXH64 (seed 0) of the reference's test vectors."""
    assert Z.xxh64(b"") == 0xEF46DB3751D8E999
    assert Z.xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert Z.xxh64(b"abc") == 0x44BC2CF5AD770999

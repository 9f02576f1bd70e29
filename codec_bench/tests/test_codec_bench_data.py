"""The seeded generators: seeds differ, blocks are distinct, the block
mix compresses as the original corpus does, and a PNG's IDAT payloads join
into a stream that the reference inflates to the image's scanlines."""

import zlib

import numpy as np
import pytest

from codec_bench.data import common, png_kodak, silesia_blocks
from codec_bench.reference import inflate as ref_inflate

BLOCK = {"block_bytes": 65536, "level": 6}
PNG = {"height": 32, "width": 40, "level": 6, "strategy": "Z_FILTERED",
       "window_bits": 15, "idat_bytes": 512, "texture": 12, "noise": 4}


def test_same_seed_same_blocks_other_seed_other_blocks():
    a = silesia_blocks.make_blocks(2**40 + 3, 0, 1, 10, 4096)
    assert a == silesia_blocks.make_blocks(2**40 + 3, 0, 1, 10, 4096)
    b = silesia_blocks.make_blocks(2**40 + 4, 0, 1, 10, 4096)
    assert all(x != y for x, y in zip(a, b))


@pytest.mark.parametrize("seed", [0, 7, -5, 2**31 + 11, 2**70 + 1])
def test_every_block_of_a_pool_is_distinct(seed):
    pool = silesia_blocks.make_pool({"block_bytes": 1024, "level": 6}, seed,
                                    3, 400, encode=False)
    blocks = [b for batch in pool for b in batch.raw]
    assert len(set(blocks)) == len(blocks) == 1200


def test_three_byte_units_stay_distinct_across_batches():
    units = set()
    for j in range(4):
        rng = common.rng(1, j)
        for b in silesia_blocks._repeated(rng, 3000, 64, (j, 4)):
            if b[:3] * 2 == b[:6] and b[3:6] == b[:3]:
                units.add(b[:3])
    assert len(units) > 2000
    n3 = sum(1 for j in range(4) for b in silesia_blocks._repeated(
        common.rng(1, j), 3000, 64, (j, 4)) if b[:3] == b[3:6])
    assert len(units) == n3


def test_kinds_and_sizes_follow_the_original_mix():
    raw = silesia_blocks.make_blocks(3, 0, 1, 10, 65536)
    assert [len(b) == 65536 for b in raw] == [False, True, True, True,
                                              True] * 2
    assert 60000 < len(raw[0]) < 65536 and raw[0].count(b" ") > 10000
    assert raw[1].startswith(b'<row id="')
    unit = raw[3][:256]
    assert any(raw[3] == (unit[:n] * (65536 // n + 1))[:65536]
               for n in silesia_blocks.UNIT_LENGTHS)


def test_zlib6_ratio_is_near_the_original_corpus():
    from defl_tpu_torch.corpus import make_silesia_like

    orig = make_silesia_like(64 * 65536, 65536)
    new = silesia_blocks.make_blocks(11, 0, 1, 64, 65536)

    def ratio(blocks):
        return sum(map(len, blocks)) / sum(len(zlib.compress(b, 6))
                                           for b in blocks)
    assert abs(ratio(new) / ratio(orig) - 1) < 0.05
    for k in range(5):
        assert abs(ratio(new[k::5]) / ratio(orig[k::5]) - 1) < 0.2


def test_pool_streams_inflate_to_their_blocks():
    pool = silesia_blocks.make_pool({"block_bytes": 4096, "level": 6}, 9, 2,
                                    20)
    for b in pool:
        assert b.inputs is b.streams
        assert ref_inflate.inflate_all(b.streams) == b.raw


def _unfilter(scan, h, w):
    """PNG reconstruction, row by row (the reference loop)."""
    stride = 3 * w
    rows = np.frombuffer(scan, np.uint8).reshape(h, stride + 1)
    img = np.zeros((h, stride), np.int64)
    for y in range(h):
        f, x = rows[y, 0], rows[y, 1:].astype(np.int64)
        up = img[y - 1] if y else np.zeros(stride, np.int64)
        out = np.zeros(stride, np.int64)
        for i in range(stride):
            a = out[i - 3] if i >= 3 else 0
            b = up[i]
            c = up[i - 3] if (i >= 3 and y) else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (x[i] + pred) & 0xFF
        img[y] = out
    return img.reshape(h, w, 3).astype(np.uint8)


def test_filtered_scanlines_reconstruct_the_image_and_use_filters():
    img = png_kodak.make_images(common.rng(4, 0), 1, 32, 40, PNG)[0]
    scan = png_kodak.filter_rows(img)
    assert len(scan) == 32 * (1 + 3 * 40)
    assert np.array_equal(_unfilter(scan, 32, 40), img)
    filters = set(scan[k * 121] for k in range(32))
    assert filters <= {0, 1, 2, 3, 4} and len(filters) > 1


def test_png_idat_chunks_join_into_the_scanlines_stream():
    pool = png_kodak.make_pool(PNG, 2**33 + 5, 2, 3)
    for b in pool:
        assert ref_inflate.inflate_all(b.streams) == b.raw
        for views, stream, raw in zip(b.inputs, b.streams, b.raw):
            assert len(raw) == 32 * (1 + 3 * 40)
            assert all(len(v) == 512 for v in views[:-1])
            assert 0 < len(views[-1]) <= 512
            png = views[0].obj
            assert png_kodak.idat_payloads(png) == [bytes(v) for v in views]
            assert b"".join(views) == stream


def test_png_seeds_differ_and_repeat():
    a = png_kodak.make_pool(PNG, 1, 1, 2)[0]
    assert a.raw == png_kodak.make_pool(PNG, 1, 1, 2)[0].raw
    assert png_kodak.make_pool(PNG, 2, 1, 2)[0].raw[0] != a.raw[0]
    assert a.raw[0] != a.raw[1]


def test_a_corrupt_chunk_crc_is_refused():
    png, _ = png_kodak.encode_png(bytes(100), 1, 33, PNG)
    bad = bytearray(png)
    bad[40] ^= 1
    with pytest.raises(ValueError):
        png_kodak.idat_payloads(bytes(bad))

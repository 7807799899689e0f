"""Damaged PNG, JPEG and TIFF files against cv2 5.0: what the port reads
equals cv2's decode, and where cv2 returns None the port raises
UnreadableImage; no other exception class escapes `read_image`.

  * seeded sweeps (`tools/probe_formats.py`'s writers and damage: the file
    cut at a random byte or one to three bytes changed anywhere) over PNG,
    baseline / progressive / arithmetic / lossless JPEG, LZW / deflate /
    PackBits TIFF and CCITT Group 3 / Group 4 / RLEW TIFF, in every mode;
  * the faults of the readers before this slice, each on its own: a PNG cut
    inside a chunk, JPEG tables that libjpeg refuses (a DHT whose counts
    run past its segment or past 256 codes, a DQT cut short), a Huffman
    code that is in no table (libjpeg-turbo warns and reads on), a
    progressive file cut inside a marker segment between its scans (libjpeg
    reads the rest of the segment from its fake EOI), and LZW TIFF with
    bytes changed (libtiff 4.7's LZWDecode keeps the rows before a bad
    code);
  * kgtpu's DSB2018 and neural_cells readers skip a mask cv2 cannot read;
    so do the port's, on a truncated mask PNG.

Every comparison is exact (dtype, shape and every value).
"""

import os
import warnings

import cv2
import numpy as np
import pytest

from kgtpu_torch.data.imread import MODES, UnreadableImage, UnsupportedImage, read_image
from tools import probe_formats as pf
from tools import variant_encoders as ve

cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
_CV = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
       "unchanged": cv2.IMREAD_UNCHANGED}


def outcome(path: str, mode: str) -> str:
    """"equal", "refused" (both), or "queued" (a Group 3 strip whose data
    ends before its last row: cv2 reads on, the port raises UnsupportedImage,
    ROADMAP §1); anything else fails the test."""
    want = cv2.imread(path, _CV[mode])
    if want is not None and want.ndim == 3:
        want = want[..., [2, 1, 0, 3][:want.shape[2]]]
    try:
        got = read_image(path, mode)
    except UnreadableImage:
        assert want is None, (path, mode, "cv2 reads it")
        return "refused"
    except UnsupportedImage as e:
        assert want is not None and "Group 3 CCITT data that ends before" in str(e), (path, e)
        return "queued"
    assert want is not None, (path, mode, "cv2 returns None")
    assert (got.dtype, got.shape) == (want.dtype, want.shape), (path, mode)
    np.testing.assert_array_equal(got, want, err_msg=f"{path} {mode}")
    return "equal"


def write(path, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


@pytest.mark.parametrize("kind", pf.KINDS)
def test_damaged_files_read_or_refuse_like_cv2(tmp_path, kind):
    """25 damaged files of the kind (cut or bytes changed), every mode."""
    rng = np.random.default_rng(pf.KINDS.index(kind))
    path = str(tmp_path / "image.png")
    seen = {"equal": 0, "refused": 0, "queued": 0}
    for _ in range(25):
        write(path, pf.damage(pf.make(kind, rng), rng))
        for mode in MODES:
            seen[outcome(path, mode)] += 1
    # libpng's CRCs refuse every damaged PNG
    assert (seen["equal"] > 0 or kind == "png") and seen["refused"] > 0, seen
    assert seen["queued"] <= (15 if kind == "ccitt_g3" else 0), seen


def test_png_cut_inside_a_chunk_is_unreadable(tmp_path):
    """Every cut of a small PNG (libpng's CRC / length checks): cv2 returns
    None and the port raises UnreadableImage (it raised struct.error when
    the cut fell in a chunk's CRC)."""
    data = cv2.imencode(".png", pf._content(np.random.default_rng(0), 12, 16))[1].tobytes()
    path = str(tmp_path / "cut.png")
    for cut in range(1, len(data)):
        write(path, data[:cut])
        for mode in MODES:
            assert outcome(path, mode) == "refused"


def _jpeg_tables_refused():
    base = cv2.imencode(".jpg", pf._content(np.random.default_rng(1), 16, 24))[1].tobytes()
    at = base.index(b"\xff\xc4")
    length = int.from_bytes(base[at + 2:at + 4], "big")
    counts = bytearray(base)
    counts[at + 5 + 15] = 200                       # a count running past the segment
    over = bytearray(base)
    over[at + 5:at + 5 + 16] = bytes([0, 0, 0, 0, 0, 0, 0, 0, 255, 255, 0, 0, 0, 0, 0, 0])
    q = base.index(b"\xff\xdb")
    short_dqt = base[:q + 2] + (40).to_bytes(2, "big") + base[q + 4:q + 4 + 38] + \
        base[q + 2 + 67:]
    cut_dht = base[:at + 4 + length // 2]
    return {"dht_counts_past_segment": bytes(counts), "dht_over_256_codes": bytes(over),
            "dqt_of_38_entries": short_dqt, "cut_inside_dht": cut_dht}


@pytest.mark.parametrize("name", sorted(_jpeg_tables_refused()))
def test_jpeg_tables_libjpeg_refuses_are_unreadable(tmp_path, name):
    """libjpeg-turbo's get_dht / get_dqt refusals: cv2 returns None, and the
    port raises UnreadableImage (IndexError / ValueError before)."""
    path = write(tmp_path / "t.jpg", _jpeg_tables_refused()[name])
    for mode in MODES:
        assert outcome(path, mode) == "refused"


@pytest.mark.parametrize("progressive", [0, 1])
def test_bad_huffman_code_reads_on_like_libjpeg(tmp_path, progressive):
    """16 one bits (stuffed, 0xFF 0x00 twice) planted in the entropy-coded
    data of the first scan: a code in no table, which libjpeg-turbo warns of
    and reads on after, 17 bits taken as symbol 0.  cv2 reads the file, and
    so does the port (it raised UnreadableImage)."""
    img = pf._content(np.random.default_rng(2), 40, 56)
    data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                      cv2.IMWRITE_JPEG_PROGRESSIVE, progressive])[1].tobytes()
    segs = ve.jpeg_segments(data)
    sos = [k for k, (m, _) in enumerate(segs) if m == 0xDA][1 if progressive else 0]
    m, seg = segs[sos]
    head = 2 + int.from_bytes(seg[2:4], "big")
    read = 0
    for at in range(head + 3, len(seg) - 2, max((len(seg) - head) // 12, 1)):
        if seg[at - 1] == 0xFF:
            continue
        planted = seg[:at] + b"\xff\x00\xff\x00" + seg[at:]
        out = b"".join(s if k != sos else planted for k, (_, s) in enumerate(segs))
        path = write(tmp_path / "b.jpg", data[:2] + out + b"\xff\xd9")
        for mode in MODES:
            read += outcome(path, mode) == "equal"
    assert read >= 30


def test_progressive_cut_inside_a_marker_segment_reads_like_cv2(tmp_path):
    """A progressive file cut at every byte of the DHT and SOS segments
    between its scans: libjpeg reads the rest of a segment from the fake EOI
    its source manager inserts, then refuses the segment or outputs the
    scans it has (the port raised IndexError there)."""
    img = pf._content(np.random.default_rng(3), 32, 48)
    data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    path = str(tmp_path / "p.jpg")
    pos, seen = 2, {"equal": 0, "refused": 0}
    for m, seg in ve.jpeg_segments(data):
        if m in (0xC4, 0xDA) and pos > data.index(b"\xff\xda"):
            header = 4 + int.from_bytes(seg[2:4], "big") - 2
            for cut in range(pos + 1, pos + header, 2):
                write(path, data[:cut])
                for mode in MODES:
                    seen[outcome(path, mode)] += 1
        pos += len(seg)
    assert seen["equal"] > 0 and seen["refused"] > 0, seen


def test_damaged_lzw_tiff_reads_like_cv2(tmp_path):
    """cv2's own LZW TIFF (64x80 RGB) with one to three bytes of its strip
    changed, 40 times: libtiff 4.7's LZWDecode keeps the bytes decoded
    before a bad code and zeros after, the RGBA reader keeps them (the port
    raised UnreadableImage)."""
    rng = np.random.default_rng(4)
    data = cv2.imencode(".tif", pf._content(rng, 64, 80))[1].tobytes()
    from kgtpu_torch.data.tiff import _Dir
    d = _Dir(data)
    off, cnt = d.offsets[0], d.counts[0]
    path = str(tmp_path / "l.tif")
    read = 0
    for _ in range(40):
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            b[off + int(rng.integers(0, cnt))] ^= int(rng.integers(1, 256))
        write(path, bytes(b))
        for mode in MODES:
            read += outcome(path, mode) == "equal"
    assert read >= 60


def _truncated_mask_tree(root, rng, layout):
    """A DSB2018 or neural_cells (masks/ layout) tree of two samples whose
    second mask PNG is cut short."""
    lab = np.zeros((24, 30), np.uint8)
    lab[3:10, 4:12], lab[12:20, 15:26] = 1, 2
    img = rng.integers(0, 256, (24, 30, 3)).astype(np.uint8)
    for iid in ("a", "b"):
        if layout == "dsb2018":
            images, masks = root / iid / "images", root / iid / "masks"
            image = images / f"{iid}.png"
        else:
            images, masks = root / "images", root / "masks" / iid
            image = images / f"{iid}.png"
        os.makedirs(images, exist_ok=True)
        os.makedirs(masks, exist_ok=True)
        cv2.imwrite(str(image), img)
        for k in (1, 2):
            m = cv2.imencode(".png", ((lab == k) * 255).astype(np.uint8))[1].tobytes()
            write(masks / f"m{k}.png", m[:len(m) - 20] if k == 2 else m)


@pytest.mark.parametrize("layout", ["dsb2018", "neural_cells"])
def test_readers_skip_a_truncated_mask_like_kgtpu(tmp_path, layout):
    """kgtpu's reader skips the cut mask (cv2.imread returns None); the
    port's skips it too (UnreadableImage) instead of failing on a
    struct.error, and the label maps are equal."""
    from test_torch_datasets import assert_same_samples
    _truncated_mask_tree(tmp_path, np.random.default_rng(5), layout)
    if layout == "dsb2018":
        from kgtpu.data.dsb2018 import DSB2018 as Theirs
        from kgtpu_torch.data.dsb2018 import DSB2018 as Ours
    else:
        from kgtpu.data.neural_cells import NeuralCells as Theirs
        from kgtpu_torch.data.neural_cells import NeuralCells as Ours
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for split in ("train", "val"):
            ours, theirs = Ours(str(tmp_path), split), Theirs(str(tmp_path), split)
            if len(theirs):
                assert_same_samples(ours, theirs)
                assert all(np.unique(ours[k]["label_map"]).tolist() == [0, 1]
                           for k in range(len(ours)))


def test_probe_reports_its_counts(capsys):
    """`tools/probe_formats.py` runs (a few files in one process) and prints
    its per-kind counts, the tool PERF.md's damage counts come from."""
    rc = pf.main(["--files", "22", "--workers", "1", "--kinds", "png,jpeg_baseline"])
    out = capsys.readouterr().out
    assert rc == 0 and "22 damaged files" in out and "0 mismatches" in out


def test_probe_writers_make_files_both_read(tmp_path):
    """The sweeps' writers make files cv2 and the port read alike (before
    any damage)."""
    rng = np.random.default_rng(6)
    path = str(tmp_path / "w.png")
    for kind in pf.KINDS:
        write(path, pf.make(kind, rng))
        assert outcome(path, "color") == "equal"


"""AVIF: the HEIF / ISO-BMFF container as libavif 1.4.2 parses it for cv2
5.0's `grfmt_avif.cpp` (which turns libavif's strict checks off), then
cv2's own steps on top.

Container (ISO/IEC 23008-12, 14496-12, AV1 Image File Format), checked
as libavif checks it (a refusal raises `UnreadableImage`: cv2's imread
returns None):
  * top level: `ftyp` first, naming avif or avis (major or compatible),
    then `meta` and / or `moov`; libavif stops reading once it holds what
    the brands need, so what follows does not matter; box headers (32-
    and 64-bit sizes, size 0 to the end at top level, `uuid`) must fit;
  * `meta` (FullBox 0): `hdlr` first (version 0, pre_defined 0, 'pict',
    a terminated name), at most one each of `iloc` (v0-2, field sizes 0 /
    4 / 8, construction methods 0 and 1, no extent_index read), `pitm`,
    `idat`, `iprp` (`ipco` first, then only `ipma`: ordered item ids,
    property indices inside `ipco`, essential unknown properties disable
    the item), `iinf` (v0-1, exactly its count of `infe` v2-3), `iref`
    (v0-1: `auxl` alpha, `dimg` grid tiles, `thmb`, `cdsc`, `prem`);
  * properties: `ispe`, `av1C` (marker 0x81), `pixi` (equal depths of 1 to
    16, matching av1C on a decoded item), `colr` (nclx; ICC read and ignored, as cv2
    ignores it), `auxC`, `irot` / `imir` / `clap` / `pasp` (parsed; neither
    libavif nor cv2 applies them to the pixels);
  * the primary item (`av01`, or `grid`: ImageGrid over its `dimg` tiles);
    for a file whose major brand is `avis`, the first sample of the
    sequence's colour track (and alpha track) instead, as libavif's
    AVIF_DECODER_SOURCE_AUTO picks;
  * an alpha auxiliary item or track (`auxC` alpha URN) of the same size.
cv2 then sizes its Mat from the header (ispe, av1C's depth and chroma
layout, alpha present) and converts (`avif_color.to_mat`); where av1C
promises more than an 8-bit frame holds, cv2's "unchanged" read is not
defined (half of each 16-bit row left as it was): `UnsupportedImage` under
the variants item.  A coded frame
whose size differs from `ispe` is rescaled by libavif with libyuv's
ScalePlane, which this port does not have: such a file raises
`UnsupportedImage` under the same ROADMAP item.
"""

from __future__ import annotations

import numpy as np

from kgtpu_torch.data.imread import CONTAINERS, QUEUED, UnreadableImage, unsupported

ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
              b"urn:mpeg:hevc:2015:auxid:1")
SUPPORTED_PROPS = (b"ispe", b"auxC", b"colr", b"av1C", b"pasp", b"clap", b"irot", b"imir",
                   b"pixi", b"a1op", b"lsel", b"a1lx", b"clli")


class Item:
    def __init__(self, item_id: int):
        self.id = item_id
        self.type = b""
        self.extents: list = []
        self.idat = False
        self.props: list = []
        self.unsupported_essential = False
        self.ipma_seen = False
        self.aux_for = 0
        self.thumb_for = 0
        self.desc_for = 0
        self.dimg_for = 0
        self.dimg_idx = 0


def _fail(why: str):
    return UnreadableImage(f"AVIF: {why}")


class _R:
    """A bounded big-endian reader over data[pos:end]."""

    def __init__(self, data: bytes, pos: int, end: int):
        self.d, self.p, self.e = data, pos, end

    def left(self) -> int:
        return self.e - self.p

    def u(self, n: int) -> int:
        if n == 0:
            return 0
        if self.p + n > self.e:
            raise _fail("a box is too short for its fields")
        v = int.from_bytes(self.d[self.p:self.p + n], "big")
        self.p += n
        return v

    def raw(self, n: int) -> bytes:
        if self.p + n > self.e:
            raise _fail("a box is too short for its fields")
        v = self.d[self.p:self.p + n]
        self.p += n
        return v

    def string(self) -> bytes:
        at = self.d.find(b"\0", self.p, self.e)
        if at < 0:
            raise _fail("a string has no NULL terminator")
        v = self.d[self.p:at]
        self.p = at + 1
        return v

    def full(self, want: int | None = None) -> tuple[int, int]:
        v = self.u(4)
        if want is not None and v >> 24 != want:
            raise _fail(f"expecting box version {want}, got {v >> 24}")
        return v >> 24, v & 0xFFFFFF

    def header(self, top: bool = False) -> tuple[bytes, int, int, bool]:
        """(type, body start, box end, size zero) of the box at the reader's
        position; the reader moves to the body."""
        start = self.p
        size = self.u(4)
        typ = self.raw(4)
        zero = False
        if size == 1:
            size = self.u(8)
        elif size == 0:
            if not top:
                raise _fail("box size 0 below the top level")
            zero = True
        if typ == b"uuid":
            self.raw(16)
        hdr = self.p - start
        if zero:
            end = self.e
        else:
            if size < hdr:
                raise _fail("box header size is too small")
            end = start + size
            if end > self.e:
                raise _fail("box is truncated")
        return typ, self.p, end, zero


def _children(data: bytes, start: int, end: int):
    r = _R(data, start, end)
    while r.left() > 0:
        typ, body, bend, _ = r.header()
        yield typ, body, bend
        r.p = bend


class Meta:
    def __init__(self):
        self.items: dict = {}
        self.props: list = []
        self.primary = 0
        self.idat = b""

    def item(self, item_id: int) -> Item:
        if item_id == 0:
            raise _fail("invalid item ID 0")
        if item_id not in self.items:
            self.items[item_id] = Item(item_id)
        return self.items[item_id]


def _property(data: bytes, typ: bytes, start: int, end: int) -> dict:
    r = _R(data, start, end)
    p = {"type": typ}
    if typ == b"ispe":
        r.full(0)
        p["w"], p["h"] = r.u(4), r.u(4)
    elif typ == b"pixi":
        r.full(0)
        n = r.u(1)
        if n == 0 or n > 4:
            raise _fail("pixi plane count is not 1 to 4")
        depths = [r.u(1) for _ in range(n)]
        if any(d != depths[0] for d in depths):
            raise _fail("pixi plane depths differ")
        if depths[0] == 0 or depths[0] > 16:
            raise _fail("pixi plane depth is not 1 to 16")
        # a depth of 1 to 16 other than 8, 10 or 12 fails only an item that
        # is decoded (`_check_props`: it differs from av1C's)
        p["depths"] = depths
    elif typ == b"av1C":
        b0, b1, b2 = r.u(1), r.u(1), r.u(1)
        if b0 != 0x81:
            raise _fail("av1C marker and version are not 0x81")
        p["profile"] = b1 >> 5
        p["depth"] = 12 if b2 & 0x20 else 10 if b2 & 0x40 else 8
        p["mono"] = (b2 >> 4) & 1
        p["ssx"], p["ssy"] = (b2 >> 3) & 1, (b2 >> 2) & 1
    elif typ == b"colr":
        ct = r.raw(4)
        if ct == b"nclx":
            cp, tc, mc, b = r.u(2), r.u(2), r.u(2), r.u(1)
            if b & 0x7F:
                raise _fail("colr nclx has nonzero reserved bits")
            p["cicp"] = (cp, tc, mc, b >> 7)
        elif ct in (b"rICC", b"prof"):
            p["icc"] = True
    elif typ in (b"auxC", b"auxi"):
        r.full(0)
        p["urn"] = r.string()
    elif typ == b"clap":
        p["clap"] = [r.u(4) for _ in range(8)]
    elif typ == b"pasp":
        r.u(4)
        r.u(4)
    elif typ == b"irot":
        p["angle"] = r.u(1) & 3
    elif typ == b"imir":
        p["axis"] = r.u(1) & 1
    return p


def _parse_meta(data: bytes, start: int, end: int) -> Meta:
    m = Meta()
    r = _R(data, start, end)
    r.full(0)
    first = True
    seen: set = set()
    kids = list(_children(data, r.p, end))
    if not kids:
        raise _fail("meta has no child boxes")
    for typ, body, bend in kids:
        if first:
            if typ != b"hdlr":
                raise _fail("meta does not start with hdlr")
            h = _R(data, body, bend)
            h.full(0)
            if h.u(4) != 0:
                raise _fail("hdlr pre_defined is not zero")
            if h.raw(4) != b"pict":
                raise _fail("hdlr handler_type is not pict")
            h.raw(12)
            h.string()
            first = False
            continue
        if typ in (b"iloc", b"pitm", b"idat", b"iprp", b"iinf", b"iref"):
            if typ in seen:
                raise _fail(f"meta holds two {typ.decode()} boxes")
            seen.add(typ)
        if typ == b"iloc":
            _iloc(data, body, bend, m)
        elif typ == b"pitm":
            pr = _R(data, body, bend)
            v, _ = pr.full()
            m.primary = pr.u(2 if v == 0 else 4)
        elif typ == b"idat":
            m.idat = data[body:bend]
        elif typ == b"iprp":
            _iprp(data, body, bend, m)
        elif typ == b"iinf":
            _iinf(data, body, bend, m)
        elif typ == b"iref":
            _iref(data, body, bend, m)
    return m


def _iloc(data, start, end, m: Meta) -> None:
    r = _R(data, start, end)
    v, _ = r.full()
    if v > 2:
        raise _fail("iloc version above 2")
    b = r.u(1)
    off_size, len_size = b >> 4, b & 15
    b = r.u(1)
    base_size, idx_size = b >> 4, (b & 15) if v in (1, 2) else 0
    for s in (off_size, len_size, base_size, idx_size):
        if s not in (0, 4, 8):
            raise _fail("iloc field size is not 0, 4 or 8")
    count = r.u(2 if v < 2 else 4)
    for _ in range(count):
        it = m.item(r.u(2 if v < 2 else 4))
        if it.extents:
            raise _fail("iloc gives an item two sets of extents")
        if v in (1, 2):
            method = r.u(2) & 15
            if method not in (0, 1):
                raise _fail("iloc construction method 2 is not supported")
            it.idat = method == 1
        r.u(2)  # data_reference_index, not checked
        base = r.u(base_size)
        for _ in range(r.u(2)):
            it.extents.append((base + r.u(off_size), r.u(len_size)))


def _iprp(data, start, end, m: Meta) -> None:
    r = _R(data, start, end)
    typ, body, bend, _ = r.header()
    if typ != b"ipco":
        raise _fail("iprp does not start with ipco")
    m.props = [_property(data, t, b, e) for t, b, e in _children(data, body, bend)]
    r.p = bend
    seen_vf: set = set()
    while r.left() > 0:
        typ, body, bend, _ = r.header()
        if typ != b"ipma":
            raise _fail("iprp holds a box other than ipma")
        q = _R(data, body, bend)
        vf = q.u(4)
        if vf in seen_vf:
            raise _fail("two ipma boxes with the same version and flags")
        seen_vf.add(vf)
        v, flags = vf >> 24, vf & 0xFFFFFF
        prev = 0
        for _ in range(q.u(4)):
            item_id = q.u(2 if v < 1 else 4)
            it = m.item(item_id)
            if item_id <= prev:
                raise _fail("ipma item IDs do not increase")
            prev = item_id
            if it.ipma_seen:
                raise _fail("two ipma entries for one item")
            it.ipma_seen = True
            for _ in range(q.u(1)):
                if flags & 1:
                    x = q.u(2)
                    essential, idx = x >> 15, x & 0x7FFF
                else:
                    x = q.u(1)
                    essential, idx = x >> 7, x & 0x7F
                if idx == 0:
                    if essential:
                        raise _fail("ipma marks property index 0 essential")
                    continue
                if idx > len(m.props):
                    raise _fail("ipma property index past ipco")
                prop = m.props[idx - 1]
                if prop["type"] in SUPPORTED_PROPS:
                    if essential and prop["type"] == b"a1lx":
                        raise _fail("a1lx marked essential")
                    if not essential and prop["type"] in (b"a1op", b"lsel"):
                        raise _fail(f"{prop['type'].decode()} not marked essential")
                    it.props.append(prop)
                elif essential:
                    it.unsupported_essential = True
        r.p = bend


def _iinf(data, start, end, m: Meta) -> None:
    r = _R(data, start, end)
    v, _ = r.full()
    if v > 1:
        raise _fail("iinf version above 1")
    for _ in range(r.u(2 if v == 0 else 4)):
        typ, body, bend, _ = r.header()
        if typ != b"infe":
            raise _fail("iinf holds a box other than infe")
        q = _R(data, body, bend)
        iv, _ = q.full()
        if iv not in (2, 3):
            raise _fail("infe version is not 2 or 3")
        item_id = q.u(2 if iv == 2 else 4)
        q.u(2)
        itype = q.raw(4)
        q.string()
        if itype == b"mime":
            q.string()
        m.item(item_id).type = itype
        r.p = bend


def _iref(data, start, end, m: Meta) -> None:
    r = _R(data, start, end)
    v, _ = r.full()
    while r.left() > 0:
        typ, _, _, _ = r.header()
        if v > 1:
            break
        frm = r.u(2 if v == 0 else 4)
        if frm == 0:
            raise _fail("iref has item ID 0")
        for k in range(r.u(2)):
            to = r.u(2 if v == 0 else 4)
            if to == 0:
                raise _fail("iref has item ID 0")
            it = m.item(frm)
            if typ == b"thmb":
                it.thumb_for = to
            elif typ == b"auxl":
                it.aux_for = to
            elif typ == b"cdsc":
                it.desc_for = to
            elif typ == b"dimg":
                tile = m.item(to)
                tile.dimg_for = frm
                tile.dimg_idx = k


class Source:
    """One image to decode: its OBUs and properties (an item, or a track's
    first sample)."""

    def __init__(self, obus: bytes, props: list, track: bool = False):
        self.obus = obus
        self.props = props
        self.track = track

    def prop(self, t: bytes):
        for p in self.props:
            if p["type"] == t:
                return p
        return None


class _Truncated(UnreadableImage):
    """A read past the end of the bytes at hand (libavif's TRUNCATED_DATA)."""


def _item_data(data: bytes, m: Meta, it: Item) -> bytes:
    out = bytearray()
    for off, ln in it.extents:
        if it.idat:
            if off + ln > len(m.idat):
                raise _fail("item extent past idat")
            out += m.idat[off:off + ln]
        else:
            if off > len(data):
                raise _fail("item data starts past the end of the data")
            if off + ln > len(data):
                raise _Truncated("AVIF: item data is truncated")
            out += data[off:off + ln]
    return bytes(out)


def _top_level(data: bytes):
    """avifParse: (major brand, brands, Meta or None, moov or None)."""
    r = _R(data, 0, len(data))
    ftyp = meta = moov = None
    while r.p < len(data):
        start = r.p
        try:
            typ, body, end, zero = r.header(top=True)
        except UnreadableImage:
            r.p = start
            typ, body, end, zero = _cut_header(data, start)
        if ftyp is None and typ != b"ftyp":
            raise _fail("the first box is not ftyp")
        if end > len(data):
            if typ in (b"ftyp", b"meta", b"moov"):
                raise _Truncated(f"AVIF: {typ.decode()} box is truncated")
            # a box libavif skips: its end is where the next read starts
            raise _fail("reading past the end of the data")
        if typ == b"ftyp":
            if ftyp is not None:
                raise _fail("two ftyp boxes")
            f = _R(data, body, end)
            major = f.raw(4)
            f.u(4)
            if (end - f.p) % 4:
                raise _fail("ftyp compatible brands are not whole")
            brands = {major} | {data[i:i + 4] for i in range(f.p, end, 4)}
            if not ({b"avif", b"avis"} & brands):
                raise _fail("ftyp names neither avif nor avis")
            ftyp = (major, brands)
        elif typ == b"meta":
            if meta is not None:
                raise _fail("two meta boxes")
            meta = _parse_meta(data, body, end)
        elif typ == b"moov":
            if moov is not None:
                raise _fail("two moov boxes")
            moov = _parse_moov(data, body, end)
        if zero:
            break
        r.p = end
        # libavif stops reading once it holds the boxes the brands need
        if (b"avis" not in ftyp[1] or moov is not None) and \
                (b"avif" not in ftyp[1] or meta is not None):
            break
    if ftyp is None:
        raise _fail("no ftyp box")
    if (b"avif" in ftyp[1] and meta is None) or (b"avis" in ftyp[1] and moov is None):
        raise _Truncated("AVIF: a box the brands need is missing")
    return ftyp[0], ftyp[1], meta, moov


def _cut_header(data: bytes, start: int):
    """A top-level box header that the data cuts: libavif's read of it
    comes back short."""
    if len(data) - start >= 8:
        typ = data[start + 4:start + 8]
        return typ, start + 8, len(data) + 1, False
    raise _Truncated("AVIF: a box header is truncated")


def _select(major: bytes, meta, moov):
    """avifDecoderReset's choice: ("track", colour, alpha) or ("item",
    colour item, alpha item)."""
    if major == b"avis" or (major != b"avif" and moov):
        if not moov or moov[0] is None:
            raise _fail("no colour track")
        if meta is not None:
            _check_item_sizes(meta, meta.primary)  # libavif checks them for tracks too
        return "track", moov[0], moov[1]
    if meta is None:
        raise _fail("no meta box")
    color = None
    for it in meta.items.values():
        if _usable(it) and it.id == meta.primary:
            color = it
            break
    if color is None:
        raise _fail("no primary image item")
    _check_item_sizes(meta, color.id)
    alpha = None
    for it in meta.items.values():
        if _is_alpha(it, color.id):
            alpha = it
            break
    return "item", color, alpha


def parse(data: bytes):
    """(colour Source or grid, alpha Source or grid or None) as libavif's
    avifDecoderParse and first image leave them."""
    major, _, meta, moov = _top_level(data)
    kind, color, alpha = _select(major, meta, moov)
    if kind == "track":
        return color, alpha
    return _item_source(data, meta, color), \
        (_item_source(data, meta, alpha) if alpha is not None else None)


HEAD_BYTES = 500


def signature(data: bytes) -> bool:
    """cv2's AvifDecoder::checkSignature: libavif's avifDecoderParse over the
    file's first HEAD_BYTES bytes succeeds or runs out of them (then the
    file is AVIF to cv2; otherwise no decoder of cv2's takes it)."""
    head = data[:HEAD_BYTES]
    try:
        major, _, meta, moov = _top_level(head)
        kind, color, _ = _select(major, meta, moov)
        if kind == "item":
            coded = color
            if color.type == b"grid":
                _grid_header(_item_data(head, meta, color))
                coded = min((t for t in meta.items.values() if t.dimg_for == color.id),
                            key=lambda t: t.dimg_idx, default=None)
                if coded is None:
                    raise _fail("grid has no tiles")
            _check_props(Source(b"", coded.props), "colour image")
            if not any(p["type"] == b"ispe" for p in color.props):
                raise _fail("the colour image has no ispe")
            if not any(p["type"] == b"colr" and "cicp" in p for p in color.props):
                # no nclx: libavif reads the CICP from the AV1 sequence header,
                # so it reads the coded item now
                _item_data(head, meta, coded)
            for it in meta.items.values():
                if it.type == b"Exif" and it.desc_for == color.id and it.extents:
                    _item_data(head, meta, it)
    except _Truncated:
        return True
    except UnreadableImage:
        return False
    return True


SIZE_LIMIT = 16384 * 16384      # libavif's default imageSizeLimit
DIMENSION_LIMIT = 32768         # and imageDimensionLimit


def _check_size(ispe, what: str) -> None:
    """A mandatory ispe (or track size) within libavif's default limits."""
    if ispe is None:
        raise _fail(f"{what} has no ispe")
    w, h = ispe["w"], ispe["h"]
    if w == 0 or h == 0 or w > DIMENSION_LIMIT or h > DIMENSION_LIMIT or w * h > SIZE_LIMIT:
        raise _fail(f"{what} dimensions are invalid or too large ({w}x{h})")


def _is_alpha(it: Item, color_id: int) -> bool:
    aux = next((p for p in it.props if p["type"] == b"auxC"), None)
    return (it.aux_for == color_id and _usable(it) and aux is not None and
            aux.get("urn") in ALPHA_URNS)


def _check_item_sizes(meta: Meta, color_id: int) -> None:
    """libavif's avifDecoderReset: every image item it does not skip needs
    an ispe within its limits, but an alpha item of the colour item (whose
    ispe only its strict mode, off in cv2's reader, requires)."""
    for it in meta.items.values():
        if not _usable(it):
            continue
        ispe = next((p for p in it.props if p["type"] == b"ispe"), None)
        if ispe is None and _is_alpha(it, color_id):
            continue
        _check_size(ispe, f"item {it.id}")


def _usable(it: Item) -> bool:
    """Not skipped by libavif's avifDecoderItemShouldBeSkipped: some data,
    no unknown essential property, a known type, not a thumbnail."""
    return (sum(ln for _, ln in it.extents) > 0 and not it.unsupported_essential and
            it.type in (b"av01", b"grid") and not it.thumb_for)


def _item_source(data: bytes, m: Meta, it: Item):
    if it.type == b"grid":
        tiles = sorted((t for t in m.items.values() if t.dimg_for == it.id),
                       key=lambda t: t.dimg_idx)
        srcs = []
        for t in tiles:
            if t.type != b"av01" or t.unsupported_essential:
                raise _fail("grid tile is not a usable av01 item")
            srcs.append(_item_source(data, m, t))
        return ("grid", _item_data(data, m, it), it.props, srcs)
    return Source(_item_data(data, m, it), it.props)


def _check_samples(t: dict, size: int) -> None:
    """avifCodecDecodeInputFillFromSampleTable: libavif lays out every
    sample of a track (stsc, stco, stsz) and refuses one that ends past the
    file ("Exceeded avifIO's sizeHint")."""
    runs = t["stsc"]
    sizes = t["sizes"]
    k = 0
    for c, off in enumerate(t["chunks"]):
        per = 0
        for first, n, _ in runs:
            if first <= c + 1:
                per = n
        if per == 0:
            raise _fail("a track chunk holds no samples")
        for _ in range(per):
            if t["all_size"]:
                step = t["all_size"]
            elif k >= len(sizes):
                raise _fail("truncated sample table")
            else:
                step = sizes[k]
            if off + step > size:
                raise _fail("a track sample runs past the end of the data")
            off += step
            k += 1


def _version(data: bytes, typ: bytes, start: int, end: int, ok=(0,)) -> None:
    v = data[start] if start < end else 0
    if v not in ok:
        raise _fail(f"{typ.decode()} version {v} is not supported")


def _parse_stbl(data: bytes, start: int, end: int, t: dict) -> None:
    """avifParseSampleTableBox: chunk offsets and sample sizes append, as
    libavif's arrays do; every av01 sample entry holds its properties."""
    if t["stbl"]:
        raise _fail("duplicate stbl for a single track")
    t["stbl"] = True
    for ct, cb, ce in _children(data, start, end):
        q = _R(data, cb, ce)
        if ct in (b"stco", b"co64", b"stsc", b"stsz", b"stss", b"stts", b"stsd"):
            _version(data, ct, cb, ce, (0, 1) if ct == b"stsd" else (0,))
        if ct in (b"stco", b"co64"):
            q.full()
            n = q.u(4)
            t["chunks"] += [q.u(4 if ct == b"stco" else 8) for _ in range(n)]
        elif ct == b"stsz":
            q.full()
            size = q.u(4)
            n = q.u(4)
            if size:
                t["all_size"] = size
            else:
                t["sizes"] += [q.u(4) for _ in range(n)]
        elif ct == b"stsc":
            q.full()
            for k in range(q.u(4)):
                run = (q.u(4), q.u(4), q.u(4))
                if (k == 0 and run[0] != 1) or (k and run[0] <= t["stsc"][-1][0]):
                    raise _fail("stsc first chunks do not start at 1 and increase")
                t["stsc"].append(run)
        elif ct in (b"stss", b"stts"):
            q.full()
            q.raw(q.u(4) * (4 if ct == b"stss" else 8))
        elif ct == b"stsd":
            q.full()
            for _ in range(q.u(4)):
                et, eb, ee, _ = q.header()
                props = []
                if et == b"av01":
                    # VisualSampleEntry: 8 + 70 bytes before its boxes
                    if ee - eb < 78:
                        raise _fail("av01 sample entry shorter than a VisualSampleEntry")
                    props = [_property(data, pt, pb, pe)
                             for pt, pb, pe in _children(data, eb + 78, ee)]
                t["entries"].append((et, props))
                q.p = ee


def _parse_trak(data: bytes, start: int, end: int) -> dict:
    """avifParseTrackBox: tkhd (once, mandatory), mdia (mdhd, hdlr, minf's
    stbl), tref (auxl) and edts, each where libavif looks for it."""
    t = {"id": 0, "auxl": 0, "stbl": False, "edts": False, "chunks": [], "sizes": [],
         "all_size": 0, "stsc": [], "entries": []}
    for ct, cb, ce in _children(data, start, end):
        q = _R(data, cb, ce)
        if ct == b"tkhd":
            if "size" in t:
                raise _fail("trak holds two tkhd")
            _version(data, ct, cb, ce, (0, 1))
            v, _ = q.full()
            q.raw(16 if v == 1 else 8)
            t["id"] = q.u(4)
            q.raw(4 + (8 if v == 1 else 4) + 52)
            t["size"] = (q.u(4) >> 16, q.u(4) >> 16)
            # libavif sizes a track's image from tkhd, as an item's from ispe
            _check_size({"w": t["size"][0], "h": t["size"][1]}, f"track {t['id']}")
        elif ct == b"mdia":
            for mt, mb, me in _children(data, cb, ce):
                if mt == b"mdhd":
                    _version(data, mt, mb, me, (0, 1))
                elif mt == b"hdlr":
                    _version(data, mt, mb, me)
                    h = _R(data, mb, me)
                    h.full()
                    if h.u(4) != 0:
                        raise _fail("hdlr pre_defined is not zero")
                    h.raw(16)
                    h.string()
                elif mt == b"minf":
                    for nt, nb, ne in _children(data, mb, me):
                        if nt == b"stbl":
                            _parse_stbl(data, nb, ne, t)
        elif ct == b"tref":
            for rt, rb, re_ in _children(data, cb, ce):
                if rt == b"auxl":
                    t["auxl"] = _R(data, rb, re_).u(4)
        elif ct == b"edts":
            if t["edts"]:
                raise _fail("trak holds two edts")
            t["edts"] = True
            lists = [(eb, ee) for et, eb, ee in _children(data, cb, ce) if et == b"elst"]
            if len(lists) != 1:
                raise _fail("edts holds no elst, or more than one")
            eq = _R(data, *lists[0])
            ev, flags = eq.full()
            if flags & 1:  # repeating: libavif reads the one entry's duration
                if eq.u(4) != 1:
                    raise _fail("elst entry count is not 1")
                if ev > 1:
                    raise _fail(f"elst version {ev} is not supported")
                if eq.u(8 if ev == 1 else 4) == 0:
                    raise _fail("elst segment duration is 0")
    if "size" not in t:
        raise _fail("trak has no tkhd")
    return t


def _av01_props(t: dict):
    """The properties of a track's first av01 sample entry, or None."""
    return next((props for et, props in t["entries"] if et == b"av01"), None)


def _parse_moov(data: bytes, start: int, end: int):
    """The first samples of the colour track and of its alpha track, as
    libavif's avifDecoderReset picks them: the first track with a sample
    table, an ID, chunks and an av01 entry that is no auxiliary is the
    colour track; the first such track auxiliary to it whose auxi, if it
    has one, names alpha is its alpha track; both tracks' samples must lay
    out (`_check_samples`)."""
    tracks = [_parse_trak(data, body, bend)
              for typ, body, bend in _children(data, start, end) if typ == b"trak"]
    if not tracks:
        raise _fail("moov holds no track")
    usable = [t for t in tracks if t["stbl"] and t["id"] and t["chunks"] and
              _av01_props(t) is not None]
    color = next((t for t in usable if t["auxl"] == 0), None)
    if color is None:
        return None, None
    alpha = None
    for t in usable:
        auxi = next((p for p in _av01_props(t) if p["type"] == b"auxi"), None)
        if t["auxl"] == color["id"] and (auxi is None or auxi.get("urn") in ALPHA_URNS):
            alpha = t
            break
    out = []
    for t in (color, alpha):
        if t is None:
            out.append(None)
            continue
        _check_samples(t, len(data))
        first = t["all_size"] or t["sizes"][0]
        out.append(Source(data[t["chunks"][0]:t["chunks"][0] + first], _av01_props(t) + [
            {"type": b"ispe", "w": t["size"][0], "h": t["size"][1]}], track=True))
    return out[0], out[1]


def _check_props(src, what: str) -> dict:
    """av1C (which an alpha track may lack: libavif reads it only for the
    colour) and a pixi that agrees with it."""
    av1c = src.prop(b"av1C")
    if av1c is None and src.track and what == "alpha image":
        return {}
    if av1c is None:
        raise _fail(f"{what} has no av1C")
    pixi = src.prop(b"pixi")
    if pixi is not None and any(d != av1c["depth"] for d in pixi["depths"]):
        raise _fail(f"{what} pixi depth differs from av1C's")
    return av1c


def _decode(src, what: str):
    """(sequence header, frame header, planes, (width, height), av1C) of a
    Source or grid."""
    from kgtpu_torch.data.av1_decode import decode_av1
    if isinstance(src, tuple):
        return _decode_grid(src, what)
    av1c = _check_props(src, what)
    ispe = src.prop(b"ispe")
    if ispe is None and what == "colour image":
        raise _fail("the colour image has no ispe")
    seq, fh, planes = decode_av1(src.obus)
    size = (fh.upscaled_width, fh.height)
    if ispe is not None and (ispe["w"], ispe["h"]) != size:
        raise unsupported("AVIF whose ispe size differs from its AV1 frame (libavif rescales "
                          "it with libyuv)", CONTAINERS)
    return seq, fh, planes, size, av1c


def _grid_header(payload: bytes) -> tuple:
    """ImageGrid: (rows, columns, output width, output height)."""
    r = _R(payload, 0, len(payload))
    if r.u(1) != 0:
        raise _fail("ImageGrid version is not 0")
    flags = r.u(1)
    rows, cols = r.u(1) + 1, r.u(1) + 1
    out_w = r.u(4 if flags & 1 else 2)
    out_h = r.u(4 if flags & 1 else 2)
    if out_w == 0 or out_h == 0:
        raise _fail("grid has a zero size")
    return rows, cols, out_w, out_h


def _decode_grid(g, what: str):
    _, payload, props, tiles = g
    rows, cols, out_w, out_h = _grid_header(payload)
    if len(tiles) != rows * cols:
        raise _fail("grid tile count differs from its dimg references")
    decoded = [_decode(t, what + " tile") for t in tiles]
    seq, fh, first, (tw, th), av1c = decoded[0]
    for s, f, pl, size, _ in decoded:
        if size != (tw, th) or s.bit_depth != seq.bit_depth or \
                (s.ssx, s.ssy, s.num_planes) != (seq.ssx, seq.ssy, seq.num_planes):
            raise _fail("grid tiles differ")
    if tw * cols < out_w or th * rows < out_h or tw * (cols - 1) >= out_w or \
            th * (rows - 1) >= out_h:
        raise _fail("grid size does not fit its tiles")
    if tw < 64 or th < 64:
        raise _fail("grid tiles smaller than 64 (MIAF 7.3.11.4.2)")
    if seq.num_planes > 1 and ((seq.ssx and (tw & 1 or out_w & 1)) or
                               (seq.ssy and (th & 1 or out_h & 1))):
        raise _fail("grid with subsampled chroma has an odd size")
    ispe = next((p for p in props if p["type"] == b"ispe"), None)
    if ispe is None:
        raise _fail("grid has no ispe")
    planes = []
    for p in range(len(first)):
        full = np.concatenate([np.concatenate([decoded[y * cols + x][2][p] for x in range(cols)],
                                              1) for y in range(rows)], 0)
        sx = seq.ssx if p else 0
        sy = seq.ssy if p else 0
        planes.append(full[:(out_h + sy) >> sy, :(out_w + sx) >> sx])
    if (ispe["w"], ispe["h"]) != (out_w, out_h):
        raise unsupported("AVIF whose ispe size differs from its grid (libavif rescales it "
                          "with libyuv)", CONTAINERS)
    return seq, fh, planes, (out_w, out_h), av1c


def _props_of(src):
    return src[2] if isinstance(src, tuple) else src.props


def decode_avif(data: bytes, mode: str) -> np.ndarray:
    """cv2.imread of an AVIF file in `mode`, as cv2's Mat (BGR / BGRA)."""
    from kgtpu_torch.data.avif_color import to_mat
    color, alpha_src = parse(data)
    seq, fh, planes, size, av1c = _decode(color, "colour image")
    alpha = None
    if alpha_src is not None:
        declared = [next(((p["w"], p["h"]) for p in _props_of(x) if p["type"] == b"ispe"),
                         None) for x in (color, alpha_src)]
        if None not in declared and declared[0] != declared[1]:
            # libavif sizes the alpha to its own ispe / track header first
            raise _fail("the alpha image's declared size differs from the colour's")
        aseq, _, ap, asize, _ = _decode(alpha_src, "alpha image")
        if asize != size or aseq.bit_depth != seq.bit_depth:
            raise _fail("the alpha image differs from the colour's in size or bit depth")
        alpha = (ap[0], aseq.bit_depth, aseq.color_range)
    colr = next((p for p in _props_of(color) if p["type"] == b"colr" and "cicp" in p), None)
    cicp = colr["cicp"] if colr else (seq.cp, seq.tc, seq.mc, seq.color_range)
    # cv2 types its Mat from the header (av1C), libavif converts what it decoded
    if av1c["depth"] > 8 and seq.bit_depth == 8 and mode == "unchanged":
        raise unsupported("AVIF whose av1C promises more bits than its 8-bit frame, in "
                          "unchanged mode (cv2 writes 8-bit pixels into half of each row of "
                          "a 16-bit Mat and leaves the rest as it was: not defined)", QUEUED)
    return to_mat(planes, seq, cicp, alpha, mode, av1c["depth"] > 8, bool(av1c["mono"]))


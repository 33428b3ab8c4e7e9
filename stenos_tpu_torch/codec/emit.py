"""Section emission for the block codec (numpy via `xp`, plus torch twins).

Given the analysis results, build fixed-shape padded section contents +
lengths; callers compute offsets by cumsum and scatter into the output
buffer — the array form of the reference's pointer-walking emitters
(encode16x16_generic, block_compress.h:739-806). plane_sections and
block_header_bytes serve the numpy host encoder; the *_torch twins serve the
plain version of the encode kernel.
"""


def compact16(xp, rows, keep):
    """Front-pack kept values of (..., 16) rows preserving order (numpy:
    stable argsort; the dropped values follow the kept ones)."""
    order = xp.argsort(~keep.astype(bool), axis=-1, kind="stable")
    return xp.take_along_axis(rows, order, axis=-1)


def mask16(xp, eq):
    w = (1 << xp.arange(16, dtype=xp.int32))
    return xp.sum(eq.astype(xp.int32) * w, axis=-1)


def plane_sections(xp, x, info, codes, firsts):
    """Build per-plane sections. x: (..., bpp, 16, 16) int32.

    Returns dict:
      headA (..., bpp, 8), lenA — hdr8 / SAME byte / nothing (RAW)
      minsec (..., bpp, 18), lenB
      rows (..., bpp, 16, 18), lenR
    """
    from ..ops.bitpack import pack16_any

    i32 = xp.int32
    h = info["headers"]
    normal = (codes == 2) | (codes == 3)

    hdr8 = h[..., 0::2] | (h[..., 1::2] << 4)
    same = (codes == 0)[..., None]
    first_col = xp.concatenate(
        [firsts[..., None], xp.zeros(hdr8.shape[:-1] + (7,), dtype=i32)],
        axis=-1,
    )
    headA = xp.where(same, first_col, hdr8)
    lenA = xp.where(codes == 0, 1, xp.where(normal, 8, 0))

    eligible = (h != 6) & (h != 7) & (h != 15)
    mins = info["minbytes"]
    plain16 = compact16(xp, mins, eligible)
    zeros2 = xp.zeros(mins.shape[:-1] + (2,), dtype=i32)
    plainB = xp.concatenate([plain16, zeros2], axis=-1)
    n_eligible = xp.sum(eligible.astype(i32), axis=-1)

    meq = info["meq"]
    mmask = mask16(xp, meq)
    rle_mins = compact16(xp, mins, ~meq)
    rleB = xp.concatenate(
        [(mmask & 255)[..., None], (mmask >> 8)[..., None], rle_mins], axis=-1
    )
    n_kept = xp.sum((~meq).astype(i32), axis=-1)

    is_rle = codes == 3
    minsec = xp.where(is_rle[..., None], rleB, plainB)
    lenB = xp.where(normal, xp.where(is_rle, 2 + n_kept, n_eligible), 0)

    d = info["deltas"]
    bitpack = ((h >= 1) & (h <= 5)) | ((h >= 9) & (h <= 14))
    b = xp.where(bitpack, h % 8, 0)
    sub = xp.where((h < 8)[..., None], x, d)
    v = (sub - mins[..., None]) & 255
    packed = pack16_any(xp, v, b)  # (..., 16, 12)
    rows = xp.concatenate(
        [packed, xp.zeros(h.shape + (6,), dtype=i32)], axis=-1
    )
    lenR = 2 * b

    raw = h == 15
    raw_rows = xp.concatenate(
        [x, xp.zeros(h.shape + (2,), dtype=i32)], axis=-1
    )
    rows = xp.where(raw[..., None], raw_rows, rows)
    lenR = xp.where(raw, 16, lenR)

    for hh, src, keepmask in ((7, x, info["eq"]), (6, d, info["deq"])):
        sel = h == hh
        m = mask16(xp, keepmask)
        body = compact16(xp, src, ~keepmask)
        cand = xp.concatenate(
            [(m & 255)[..., None], (m >> 8)[..., None], body], axis=-1
        )
        rows = xp.where(sel[..., None], cand, rows)
        lenR = xp.where(sel, 2 + xp.sum((~keepmask).astype(i32), axis=-1), lenR)

    lenR = xp.where(normal[..., None], lenR, 0)
    return {
        "headA": headA,
        "lenA": lenA,
        "minsec": minsec,
        "lenB": lenB,
        "rows": rows,
        "lenR": lenR,
    }


def block_header_bytes(xp, codes, bpp):
    """Nibble-pack per-plane codes -> (..., ceil(bpp/2)) bytes."""
    if bpp % 2:
        pad = xp.zeros(codes.shape[:-1] + (1,), dtype=xp.int32)
        codes = xp.concatenate([codes.astype(xp.int32), pad], axis=-1)
    else:
        codes = codes.astype(xp.int32)
    return codes[..., 0::2] | (codes[..., 1::2] << 4)


def compact16_torch(rows, keep):
    """torch twin of compact16's host path: a stable sort moves kept values
    to the front in order (the dropped ones follow, as in numpy)."""
    import torch

    order = torch.sort((~keep).to(torch.uint8), dim=-1, stable=True).indices
    return torch.gather(rows, -1, order)


def mask16_torch(eq):
    import torch

    w = 1 << torch.arange(16, dtype=torch.int32, device=eq.device)
    return (eq.to(torch.int32) * w).sum(-1, dtype=torch.int32)


def plane_sections_torch(x, info, codes, firsts):
    """torch twin of plane_sections (same arguments, same dict)."""
    import torch

    from ..ops.bitpack import pack16_any_torch

    i32 = torch.int32
    dev = x.device
    h = info["headers"]
    normal = (codes == 2) | (codes == 3)

    hdr8 = h[..., 0::2] | (h[..., 1::2] << 4)
    same = (codes == 0)[..., None]
    first_col = torch.cat(
        [firsts[..., None], torch.zeros(hdr8.shape[:-1] + (7,), dtype=i32,
                                        device=dev)], -1)
    headA = torch.where(same, first_col, hdr8)
    lenA = torch.where(codes == 0, 1, torch.where(normal, 8, 0))

    eligible = (h != 6) & (h != 7) & (h != 15)
    mins = info["minbytes"]
    zeros2 = torch.zeros(mins.shape[:-1] + (2,), dtype=i32, device=dev)
    plainB = torch.cat([compact16_torch(mins, eligible), zeros2], -1)
    n_eligible = eligible.sum(-1, dtype=i32)

    meq = info["meq"]
    mmask = mask16_torch(meq)
    rleB = torch.cat([(mmask & 255)[..., None], (mmask >> 8)[..., None],
                      compact16_torch(mins, ~meq)], -1)
    n_kept = (~meq).sum(-1, dtype=i32)

    is_rle = codes == 3
    minsec = torch.where(is_rle[..., None], rleB, plainB)
    lenB = torch.where(normal, torch.where(is_rle, 2 + n_kept, n_eligible), 0)

    d = info["deltas"]
    bitpack = ((h >= 1) & (h <= 5)) | ((h >= 9) & (h <= 14))
    b = torch.where(bitpack, h % 8, 0)
    sub = torch.where((h < 8)[..., None], x, d)
    v = (sub - mins[..., None]) & 255
    rows = torch.cat([pack16_any_torch(v, b),
                      torch.zeros(h.shape + (6,), dtype=i32, device=dev)], -1)
    lenR = 2 * b

    raw = h == 15
    raw_rows = torch.cat(
        [x, torch.zeros(h.shape + (2,), dtype=i32, device=dev)], -1)
    rows = torch.where(raw[..., None], raw_rows, rows)
    lenR = torch.where(raw, 16, lenR)

    for hh, src, keepmask in ((7, x, info["eq"]), (6, d, info["deq"])):
        sel = h == hh
        m = mask16_torch(keepmask)
        cand = torch.cat([(m & 255)[..., None], (m >> 8)[..., None],
                          compact16_torch(src, ~keepmask)], -1)
        rows = torch.where(sel[..., None], cand, rows)
        lenR = torch.where(sel, 2 + (~keepmask).sum(-1, dtype=i32), lenR)

    lenR = torch.where(normal[..., None], lenR, 0)
    return {
        "headA": headA,
        "lenA": lenA,
        "minsec": minsec,
        "lenB": lenB,
        "rows": rows,
        "lenR": lenR,
    }


def block_header_bytes_torch(codes, bpp):
    """torch twin of block_header_bytes."""
    import torch

    codes = codes.to(torch.int32)
    if bpp % 2:
        codes = torch.cat([codes, torch.zeros_like(codes[..., :1])], -1)
    return codes[..., 0::2] | (codes[..., 1::2] << 4)


def partial_bound(rbytes: int, bpp: int) -> int:
    """Longest partial segment (encode_partial, without its 0xFE marker) of
    rbytes < 256 * bpp bytes: with a whole line, the code nibbles and at
    most 8 row-header bytes a plane on top of the bytes (a row is never
    longer than its 16 bytes with its minimum); else the bytes alone."""
    if rbytes < 16 * bpp:
        return rbytes
    return rbytes + (bpp + 1) // 2 + 8 * bpp


def encode_partial_torch(tail, bpp: int):
    """torch twin of encode_np.encode_partial on a (rbytes,) uint8 tensor,
    1 <= rbytes < 256 * bpp, on its device with no device-to-host copy (the
    plain version of the encode_short kernel). Returns (segment
    (partial_bound(rbytes, bpp),) uint8, length 0-d int32): the segment is
    segment[:length], zeros follow."""
    import torch

    from ..ops.bitpack import pack16_any_torch
    from ..ops.compact import compact
    from .analyze import analyze_planes_torch

    i32 = torch.int32
    dev = tail.device
    rbytes = tail.numel()
    lines = rbytes // (16 * bpp)
    if not lines:
        return tail.clone(), torch.full((), rbytes, dtype=i32, device=dev)
    # the block padded with the tail's last byte, as planes of 16 rows
    el = torch.cat([tail, tail[-1:].expand(256 * bpp - rbytes)]).view(
        256, bpp).to(i32)
    x = el.t().reshape(bpp, 16, 16)
    info = analyze_planes_torch(x, el[0], False)
    same = info["all_same"]
    h = info["headers"][:, :lines]
    mins = info["minbytes"][:, :lines]
    xs = x[:, :lines]
    hdr = block_header_bytes_torch(torch.where(same, 0, 2), bpp)
    hp = torch.cat([h, torch.zeros_like(h[:, : lines % 2])], -1)
    heads = hp[:, 0::2] | (hp[:, 1::2] << 4)
    # a row: raw (header 15), else (x or its deltas) - min at h & 7 bits
    raw = h == 15
    sub = torch.where((h < 8)[..., None], xs, info["deltas"][:, :lines])
    packed = pack16_any_torch((sub - mins[..., None]) & 255,
                              torch.where(raw, 0, h & 7))
    rows = torch.where(raw[..., None], xs,
                       torch.cat([packed, torch.zeros_like(packed[..., :4])],
                                 -1))
    len_r = torch.where(raw, 16, 2 * (h & 7))
    # a plane: [first byte (ALL_SAME) | row headers | minimums | rows]
    normal = ~same[:, None]
    values = torch.cat([x[:, 0, :1], heads, mins, rows.flatten(1)], -1)
    valid = torch.cat([
        same[:, None], normal.expand(heads.shape), normal & ~raw,
        (normal[..., None] & (torch.arange(16, device=dev) < len_r[..., None])
         ).flatten(1)], -1)
    rest = tail[lines * 16 * bpp:].to(i32)
    values = torch.cat([hdr, values.flatten(), rest])
    valid = torch.cat([torch.ones_like(hdr, dtype=torch.bool),
                       valid.flatten(),
                       torch.ones_like(rest, dtype=torch.bool)])
    width = partial_bound(rbytes, bpp)
    values = torch.cat([values, values.new_zeros(max(0, width - len(values)))])
    valid = torch.cat([valid, valid.new_zeros(len(values) - len(valid))])
    out, n = compact(values[None], valid[None])
    return out[0, :width].to(torch.uint8), n[0]

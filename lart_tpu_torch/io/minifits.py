"""Minimal native FITS codec (no astropy dependency in this image).

The reference wraps CFITSIO in src/fitsio_mod.f90:61-1307 to write its
section files; this module is the TPU framework's native equivalent,
implementing the subset of FITS the LaRT schema needs in pure numpy:

  * primary HDU (header only),
  * IMAGE extensions (BITPIX 8/16/32/64/-32/-64, NAXIS <= 4),
  * BINTABLE extensions with scalar columns (TFORM B/I/J/K/E/D/rA),
  * header keywords: bool/int/float/str, long keys via the HIERARCH
    convention,
  * transparent gzip for *.gz paths (the reference writes gz FITS too).

Files written here are standard FITS, readable by astropy/CFITSIO/fv; the
reader accepts the output of the reference Fortran code.

The port's own copy of lart_tpu/io/minifits.py, which has no jax in it:
lart_tpu_torch imports nothing of lart_tpu.  Keep the two in step.
"""

from __future__ import annotations

import gzip
from typing import Dict, List, Optional, Tuple

import numpy as np

BLOCK = 2880

_BITPIX = {
    np.dtype('uint8'): 8, np.dtype('>i2'): 16, np.dtype('>i4'): 32,
    np.dtype('>i8'): 64, np.dtype('>f4'): -32, np.dtype('>f8'): -64,
}
_DTYPE_OF_BITPIX = {8: '>u1', 16: '>i2', 32: '>i4', 64: '>i8',
                    -32: '>f4', -64: '>f8'}
_TFORM_OF_KIND = {('i', 1): 'B', ('u', 1): 'B', ('i', 2): 'I',
                  ('i', 4): 'J', ('i', 8): 'K',
                  ('u', 2): 'I', ('u', 4): 'J', ('u', 8): 'K',
                  ('f', 4): 'E', ('f', 8): 'D'}
_DTYPE_OF_TFORM = {'L': '>u1', 'B': '>u1', 'I': '>i2', 'J': '>i4',
                   'K': '>i8', 'E': '>f4', 'D': '>f8'}


class HDU:
    """One header-data unit: an ordered header dict + optional data.

    data is either an ndarray (image) or a dict of 1-D column arrays
    (binary table, insertion-ordered)."""

    def __init__(self, header: Optional[Dict] = None, data=None,
                 name: str = ''):
        self.header: Dict = dict(header or {})
        self.data = data
        self.name = name or str(self.header.get('EXTNAME', ''))

    @property
    def is_image(self) -> bool:
        return not isinstance(self.data, dict)


# --------------------------------------------------------------------------
# header cards
# --------------------------------------------------------------------------

def _fmt_value(v) -> str:
    if isinstance(v, (bool, np.bool_)):
        return 'T' if v else 'F'
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        s = repr(float(v))
        return s.replace('e', 'E').replace('inf', 'NaN').replace(
            'nan', 'NaN')
    s = str(v).replace("'", "''")
    return f"'{s:<8s}'"


def _card(key: str, v) -> bytes:
    if key.upper() in ('COMMENT', 'HISTORY'):
        card = f'{key.upper():<8s}{str(v)[:72]}'
    elif (len(key) <= 8 and key == key.upper()
          and key.replace('-', '').replace('_', '').isalnum()):
        val = _fmt_value(v)
        if not val.startswith("'"):
            val = f'{val:>20s}'
        card = f'{key.upper():<8s}= {val}'
    else:
        # HIERARCH convention for long / mixed-case keys
        card = f"HIERARCH {key} = {_fmt_value(v)}"
    card = card[:80]
    return card.ljust(80).encode('ascii', 'replace')


def _parse_value(s: str):
    s = s.strip()
    if not s:
        return None
    if s.startswith("'"):
        # find closing quote, honoring '' escapes
        out, i = [], 1
        while i < len(s):
            if s[i] == "'":
                if i + 1 < len(s) and s[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(s[i])
            i += 1
        return ''.join(out).rstrip()
    # strip trailing comment
    if '/' in s:
        s = s.split('/', 1)[0].strip()
    if s == 'T':
        return True
    if s == 'F':
        return False
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s.replace('D', 'E').replace('d', 'e'))
    except ValueError:
        return s


def _parse_card(card: bytes) -> Optional[Tuple[str, object]]:
    text = card.decode('ascii', 'replace')
    key = text[:8].strip()
    if key in ('', 'END'):
        return None
    if key in ('COMMENT', 'HISTORY'):
        return (key, text[8:].rstrip())
    if key == 'HIERARCH':
        body = text[8:]
        if '=' not in body:
            return None
        k, v = body.split('=', 1)
        return (k.strip(), _parse_value(v))
    if text[8:10] != '= ':
        return None
    return (key, _parse_value(text[10:]))


def _header_bytes(cards: List[bytes]) -> bytes:
    out = b''.join(cards) + b'END'.ljust(80)
    pad = (-len(out)) % BLOCK
    return out + b' ' * pad


def _pad_data(b: bytes) -> bytes:
    return b + b'\0' * ((-len(b)) % BLOCK)


# --------------------------------------------------------------------------
# writing
# --------------------------------------------------------------------------

def _image_hdu_bytes(hdu: HDU, primary: bool) -> bytes:
    data = hdu.data
    cards = []
    if primary:
        cards.append(_card('SIMPLE', True))
    else:
        cards.append(f"XTENSION= 'IMAGE   '".ljust(80).encode())
    if data is None:
        cards.append(_card('BITPIX', 8))
        cards.append(_card('NAXIS', 0))
    else:
        arr = np.asarray(data)
        dt = arr.dtype.newbyteorder('>')
        if dt not in _BITPIX:
            if arr.dtype.kind == 'f':
                dt = np.dtype('>f8') if arr.dtype.itemsize > 4 \
                    else np.dtype('>f4')
            elif arr.dtype.kind in 'iub':
                dt = np.dtype('>i8') if arr.dtype.itemsize > 4 \
                    else np.dtype('>i4')
            else:
                raise TypeError(f'unsupported image dtype {arr.dtype}')
            arr = arr.astype(dt)
        else:
            arr = arr.astype(dt)
        cards.append(_card('BITPIX', _BITPIX[dt]))
        cards.append(_card('NAXIS', arr.ndim))
        # FITS axis order is reversed wrt C/numpy order
        for i, n in enumerate(reversed(arr.shape)):
            cards.append(_card(f'NAXIS{i + 1}', int(n)))
    if primary:
        cards.append(_card('EXTEND', True))
    else:
        cards.append(_card('PCOUNT', 0))
        cards.append(_card('GCOUNT', 1))
    if hdu.name:
        cards.append(_card('EXTNAME', hdu.name))
    for k, v in hdu.header.items():
        if k.upper() in ('SIMPLE', 'XTENSION', 'BITPIX', 'EXTEND', 'PCOUNT',
                         'GCOUNT', 'EXTNAME') or k.upper().startswith('NAXIS'):
            continue
        cards.append(_card(k, v))
    out = _header_bytes(cards)
    if data is not None:
        out += _pad_data(arr.tobytes())
    return out


def _table_hdu_bytes(hdu: HDU) -> bytes:
    cols = hdu.data
    names = list(cols.keys())
    arrs, tforms = [], []
    for nm in names:
        a = np.asarray(cols[nm])
        if a.ndim != 1:
            raise ValueError('binary-table columns must be 1-D')
        if a.dtype.kind in 'SU':
            a = np.asarray(a, dtype='S')
            width = max(int(a.dtype.itemsize), 1)
            tforms.append(f'{width}A')
            arrs.append(a)
        else:
            key = (a.dtype.kind, a.dtype.itemsize)
            if key not in _TFORM_OF_KIND:
                a = a.astype(np.float64)
                key = ('f', 8)
            tf = _TFORM_OF_KIND[key]
            tforms.append(tf)
            arrs.append(a.astype(_DTYPE_OF_TFORM[tf]))
    nrows = arrs[0].shape[0] if arrs else 0
    rec = np.rec.fromarrays(arrs, names=names) if arrs else None
    rowbytes = rec.dtype.itemsize if rec is not None else 0

    cards = [f"XTENSION= 'BINTABLE'".ljust(80).encode(),
             _card('BITPIX', 8), _card('NAXIS', 2),
             _card('NAXIS1', rowbytes), _card('NAXIS2', nrows),
             _card('PCOUNT', 0), _card('GCOUNT', 1),
             _card('TFIELDS', len(names))]
    for i, (nm, tf) in enumerate(zip(names, tforms)):
        cards.append(_card(f'TTYPE{i + 1}', nm))
        cards.append(_card(f'TFORM{i + 1}', tf))
    if hdu.name:
        cards.append(_card('EXTNAME', hdu.name))
    for k, v in hdu.header.items():
        ku = k.upper()
        if ku in ('XTENSION', 'BITPIX', 'PCOUNT', 'GCOUNT', 'TFIELDS',
                  'EXTNAME') or ku.startswith(('NAXIS', 'TTYPE', 'TFORM')):
            continue
        cards.append(_card(k, v))
    out = _header_bytes(cards)
    if rec is not None:
        out += _pad_data(rec.tobytes())
    return out


def write_hdus(path: str, hdus: List[HDU]) -> None:
    buf = []
    for i, h in enumerate(hdus):
        if isinstance(h.data, dict):
            if i == 0:
                raise ValueError('primary HDU cannot be a table')
            buf.append(_table_hdu_bytes(h))
        else:
            buf.append(_image_hdu_bytes(h, primary=(i == 0)))
    raw = b''.join(buf)
    if path.lower().endswith('.gz'):
        with gzip.open(path, 'wb') as fh:
            fh.write(raw)
    else:
        with open(path, 'wb') as fh:
            fh.write(raw)


# --------------------------------------------------------------------------
# reading
# --------------------------------------------------------------------------

def _read_header(raw: bytes, off: int):
    header: Dict = {}
    order: List[str] = []
    while True:
        block = raw[off:off + BLOCK]
        if len(block) < BLOCK:
            raise ValueError('truncated FITS header')
        off += BLOCK
        done = False
        for i in range(0, BLOCK, 80):
            card = block[i:i + 80]
            if card[:3] == b'END' and card[3:8].strip() == b'':
                done = True
                break
            kv = _parse_card(card)
            if kv is not None:
                header[kv[0]] = kv[1]
                order.append(kv[0])
        if done:
            break
    return header, off


def read_hdus(path: str) -> List[HDU]:
    if path.lower().endswith('.gz'):
        with gzip.open(path, 'rb') as fh:
            raw = fh.read()
    else:
        with open(path, 'rb') as fh:
            raw = fh.read()
    hdus: List[HDU] = []
    off = 0
    while off < len(raw):
        header, off = _read_header(raw, off)
        xt = str(header.get('XTENSION', '')).strip().upper()
        naxis = int(header.get('NAXIS', 0))
        if xt == 'BINTABLE':
            nrows = int(header.get('NAXIS2', 0))
            rowbytes = int(header.get('NAXIS1', 0))
            nf = int(header.get('TFIELDS', 0))
            names, fmts = [], []
            for i in range(1, nf + 1):
                names.append(str(header.get(f'TTYPE{i}', f'col{i}')).strip())
                tf = str(header.get(f'TFORM{i}', 'D')).strip()
                rep = ''.join(ch for ch in tf if ch.isdigit())
                code = tf[len(rep):][:1].upper()
                if code == 'A':
                    fmts.append(f'S{rep or 1}')
                else:
                    n = int(rep) if rep else 1
                    base = _DTYPE_OF_TFORM.get(code, '>f8')
                    fmts.append(base if n == 1 else (base, (n,)))
            dt = np.dtype({'names': names, 'formats': fmts})
            if dt.itemsize != rowbytes:
                # fall back: honor NAXIS1 with padding at the row tail
                dt = np.dtype({'names': names, 'formats': fmts,
                               'itemsize': rowbytes})
            nbytes = nrows * rowbytes
            rec = np.frombuffer(raw[off:off + nbytes], dtype=dt,
                                count=nrows)
            data = {}
            for nm in names:
                col = rec[nm]
                if col.dtype.kind != 'S':
                    col = col.astype(col.dtype.newbyteorder('='))
                data[nm] = col
            hdus.append(HDU(header, data))
            off += nbytes + ((-nbytes) % BLOCK)
        else:
            if naxis == 0:
                hdus.append(HDU(header, None))
                continue
            shape = tuple(int(header[f'NAXIS{i}'])
                          for i in range(naxis, 0, -1))
            bitpix = int(header['BITPIX'])
            dt = np.dtype(_DTYPE_OF_BITPIX[bitpix])
            n = int(np.prod(shape))
            nbytes = n * dt.itemsize
            arr = np.frombuffer(raw[off:off + nbytes],
                                dtype=dt, count=n).reshape(shape)
            hdus.append(HDU(header, arr.astype(dt.newbyteorder('='))))
            off += nbytes + ((-nbytes) % BLOCK)
    return hdus

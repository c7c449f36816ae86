"""The port's copy of the host modules against lart_tpu's: every example
namelist that tests/test_examples.py resolves gives the same resolved
config through lart_tpu_torch.config as through lart_tpu.config, field for
field (exact; NaN equals NaN; a path to a bundled data file compares by
its real path, since each package finds the files from its own
directory)."""

import dataclasses
import glob
import math
import os

import pytest

from lart_tpu import config as jconfig
from lart_tpu_torch import config as tconfig

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'examples')
ALL_IN = sorted(glob.glob(os.path.join(EXAMPLES, '*', '*.in')))


def _plain(v):
    """Nested dataclasses, tuples and lists as plain values to compare."""
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, float) and math.isnan(v):
        return 'nan'
    if isinstance(v, str) and v.strip() and os.path.isfile(v.strip()):
        return os.path.realpath(v.strip())
    return v


@pytest.mark.parametrize('path', ALL_IN, ids=[
    os.path.relpath(p, EXAMPLES) for p in ALL_IN])
def test_port_config_resolves_like_lart_tpu(path):
    t = tconfig.Params.from_namelist(path)
    j = jconfig.Params.from_namelist(path)
    assert _plain(t) == _plain(j)
    tc, jc = _plain(t.resolve()), _plain(j.resolve())
    assert tc.keys() == jc.keys()
    for k in tc:
        assert tc[k] == jc[k], k

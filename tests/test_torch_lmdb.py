"""The port's LMDB reader (`ddgan_torch/data/lmdb.py`) and its LMDB datasets
(`ddgan_torch/data/lmdb_datasets.py`) on the CPU.

The reader is held against the writer of `tests/_torch_lmdb.py` (keys with
shared prefixes, an empty value, values at the inline/overflow boundary,
trees of depth 1-3, the newer of two meta pages, an empty database,
refusals) and, where the `lmdb` package is installed, against it in both
directions (skipped without it). The datasets are held item for item
against the JAX package's classes, whose `lmdb` module is replaced in the
test by a dict-backed fake holding the same entries (nothing in
`ddgan_tpu` changes): CelebA-HQ raw and encoded, LSUN over three classes,
its key cache written by either package and read by the other, and
`make_dataset` for lsun, celeba_256 and celeba, on PNG, JPEG and WebP
values (the LSUN release's format). Every comparison is exact.
"""

import io
import os
import pickle
import string
import types

import numpy as np
import pytest
from PIL import Image

import ddgan_tpu.data as jdata
import ddgan_tpu.data.lmdb_datasets as jlmdb
from ddgan_tpu.config import Config as JConfig

import ddgan_torch.data as tdata
from ddgan_torch.config import Config
from ddgan_torch.data import lmdb, lmdb_datasets as tlmdb

from _torch_lmdb import nodemax, write_lmdb

PSIZE = 4096
NODEMAX = nodemax(PSIZE)


def _read_all(path):
    """stat, the cursor's keys, (key, get(key)) for each, and the transaction."""
    env = lmdb.open(str(path), readonly=True, lock=False)
    with env.begin(write=False) as txn:
        keys = list(txn.cursor().iternext(keys=True, values=False))
        return txn.stat(), keys, [(k, txn.get(k)) for k in keys], txn


def _boundary_items(rs):
    """Keys with shared prefixes (and CelebA's "10" < "2"), an empty value,
    and values of 8 + key + value bytes at LMDB's nodemax and one past it."""
    items = {b"a": b"", b"ab": rs.bytes(3), b"abc": rs.bytes(1), b"b": rs.bytes(7),
             b"10": b"ten", b"2": b"two", b"\x00": b"nul", b"\xff" * 40: rs.bytes(9000)}
    for key in (b"inline", b"over", b"over2"):
        extra = {b"inline": 0, b"over": 1, b"over2": 2}[key]
        items[key] = rs.bytes(NODEMAX - 8 - len(key) + extra)
    return items


@pytest.mark.parametrize("max_keys,depth", [(None, 1), (6, 2), (4, 3)])
def test_reader_reads_what_the_writer_wrote(tmp_path, max_keys, depth):
    rs = np.random.RandomState(depth)
    items = _boundary_items(rs)
    if depth == 3:
        items.update({f"k{i:03d}".encode(): rs.bytes(rs.randint(0, 3000)) for i in range(10)})
    info = write_lmdb(tmp_path, items, max_keys=max_keys)
    assert info["depth"] == depth and info["overflow"] >= 3
    stat, keys, pairs, txn = _read_all(tmp_path)
    assert stat["entries"] == len(items) and stat["depth"] == depth
    assert keys == sorted(items) and keys.index(b"10") < keys.index(b"2")
    assert pairs == [(k, items[k]) for k in sorted(items)]
    for k, v in items.items():
        assert txn.get(k) == v
    for missing in (b"", b"0", b"aa", b"abcd", b"c", b"\xff" * 41, b"zzz"):
        assert txn.get(missing) is None
    with pytest.raises(ValueError, match="keys only"):
        txn.cursor().iternext(keys=True, values=True)


@pytest.mark.parametrize("txnid", [2, 3], ids=["newer_on_page_0", "newer_on_page_1"])
def test_reader_takes_the_newer_meta_page(tmp_path, txnid):
    write_lmdb(tmp_path, {b"new": b"1", b"both": b"2"}, txnid=txnid,
               older={b"old": b"0", b"both": b"9"})
    stat, keys, pairs, txn = _read_all(tmp_path)
    assert pairs == [(b"both", b"2"), (b"new", b"1")] and stat["entries"] == 2
    assert txn.get(b"old") is None


def test_reader_reads_an_empty_database(tmp_path):
    info = write_lmdb(tmp_path, {})
    assert info["bytes"] == 2 * PSIZE
    stat, keys, pairs, txn = _read_all(tmp_path)
    assert stat["entries"] == 0 and keys == [] and pairs == [] and txn.get(b"0") is None


def test_reader_refuses_what_is_not_a_whole_lmdb(tmp_path):
    items = {str(i).encode(): bytes(3000) for i in range(40)}
    write_lmdb(tmp_path / "ok", items)
    data = (tmp_path / "ok" / "data.mdb").read_bytes()
    cases = {
        "bad_magic": data[:16] + b"\x00\x00\x00\x00" + data[20:],
        "bad_magic_page_1": data[:PSIZE + 16] + b"\x01\x02\x03\x04" + data[PSIZE + 20:],
        "short": data[:100],
        "one_meta_page": data[:PSIZE],
        "cut_tree": data[:len(data) - PSIZE],
        "text": b"not an lmdb " * 400,
    }
    for name, blob in cases.items():
        (tmp_path / name).mkdir()
        (tmp_path / name / "data.mdb").write_bytes(blob)
        path = str(tmp_path / name)
        with pytest.raises(ValueError, match=name):
            env = lmdb.open(path)
            with env.begin() as txn:  # the cut tree shows when a walk reaches it
                list(txn.cursor().iternext(keys=True, values=False))
                [txn.get(k) for k in items]
    with pytest.raises(FileNotFoundError, match="no LMDB directory"):
        lmdb.open(str(tmp_path / "absent"))
    with pytest.raises(ValueError, match="read-only"):
        lmdb.open(str(tmp_path / "ok"), readonly=False)
    with pytest.raises(ValueError, match="read-only"):
        lmdb.open(str(tmp_path / "ok")).begin(write=True)


@pytest.mark.parametrize("direction", ["lmdb_to_port", "writer_to_lmdb"])
def test_real_lmdb_round_trips(tmp_path, direction):
    real = pytest.importorskip("lmdb")
    rs = np.random.RandomState(5)
    items = {**_boundary_items(rs),
             **{os.urandom(20).hex().encode(): rs.bytes(rs.randint(0, 20000))
                for _ in range(3000)}}
    if direction == "lmdb_to_port":
        env = real.open(str(tmp_path), map_size=1 << 30)
        with env.begin(write=True) as txn:
            for k, v in items.items():
                txn.put(k, v)
        env.close()
        stat, keys, pairs, txn = _read_all(tmp_path)
        assert stat["entries"] == len(items) and keys == sorted(items)
        assert all(txn.get(k) == v for k, v in items.items())
    else:
        write_lmdb(tmp_path, items)
        env = real.open(str(tmp_path), readonly=True, lock=False)
        with env.begin() as txn:
            assert txn.stat()["entries"] == len(items)
            assert list(txn.cursor().iternext(keys=True, values=False)) == sorted(items)
            assert all(txn.get(k) == v for k, v in items.items())


# ---------------------------------------------------------------- datasets
class FakeLMDB:
    """The `lmdb` API that `ddgan_tpu/data/lmdb_datasets.py` calls, over
    dicts registered by path; values come back as buffers, as py-lmdb's
    `begin(buffers=True)` gives them."""

    def __init__(self):
        self.dbs = {}

    def open(self, path, **kw):
        items = self.dbs[os.path.normpath(path)]
        return types.SimpleNamespace(begin=lambda write=False, buffers=False: _FakeTxn(items))


class _FakeTxn:
    def __init__(self, items):
        self.items = items

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def get(self, key):
        return memoryview(self.items[bytes(key)]) if bytes(key) in self.items else None

    def stat(self):
        return {"entries": len(self.items)}

    def cursor(self):
        return _FakeCursor(sorted(self.items))


class _FakeCursor:
    def __init__(self, keys):
        self.keys = keys

    def iternext(self, keys=True, values=False):
        assert keys and not values
        return iter(self.keys)


@pytest.fixture
def fake(monkeypatch):
    f = FakeLMDB()
    monkeypatch.setattr(jlmdb, "_lmdb", f)
    return f


def _both_dbs(fake, path, items):
    write_lmdb(path, items)
    fake.dbs[os.path.normpath(str(path))] = dict(items)


def _smooth(rs, h, w, c):
    yy, xx = np.mgrid[0:h, 0:w]
    planes = [127 + 90 * np.sin(a * xx + p) * np.cos(b * yy) + rs.normal(0, 14, (h, w))
              for a, b, p in rs.uniform(0.02, 0.25, (c, 3))]
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


def _encoded(rs, i):
    """An encoded image of a size that needs a resize and a crop: RGB JPEG at
    4:2:0 and 4:4:4, a grey JPEG, an RGB PNG and a grey PNG."""
    h, w = [(20, 26), (31, 17), (24, 24), (18, 22), (26, 20)][i % 5]
    arr = _smooth(rs, h, w, 3)
    im = Image.fromarray(arr[:, :, 0]) if i % 5 in (2, 4) else Image.fromarray(arr)
    buf = io.BytesIO()
    if i % 5 < 3:
        im.save(buf, format="JPEG", quality=90, subsampling=2 * (i % 2))
    else:
        im.save(buf, format="PNG")
    return buf.getvalue()


def _assert_items(jds, tds, indices):
    for i in indices:
        (jx, jy), (tx, ty) = jds[i], tds[i]
        want = np.asarray(jx)
        assert isinstance(tx, np.ndarray) and tx.dtype == want.dtype and tx.shape == want.shape
        assert np.array_equal(tx, want), i
        assert ty == jy


TRANSFORMS = [
    {},
    {"do_resize": "yes", "to_tensor_transform": "yes", "use_normalize": "yes",
     "CenterCrop": "yes"},
]


def _configs(flags, **kw):
    cfg = dict(image_size=16, num_channels=3, to_tensor_transform="no", use_normalize="no",
               CenterCrop="no", **kw)
    cfg.update(flags)
    return JConfig(**cfg), Config(**cfg)


@pytest.mark.parametrize("flags", TRANSFORMS, ids=["none", "resize_tensor_norm_crop"])
def test_celeba_lmdb_items_match(tmp_path, fake, flags):
    """Encoded values (make_dataset's celeba_256 and celeba) and raw ones
    (sqrt(len / 3)-sided RGB), keys str(index), validation split included."""
    rs = np.random.RandomState(3)
    _both_dbs(fake, tmp_path / "train.lmdb", {str(i).encode(): _encoded(rs, i) for i in range(12)})
    raw = {str(i).encode(): rs.randint(0, 256, (s * s * 3,)).astype(np.uint8).tobytes()
           for i, s in enumerate([16, 20, 9])}
    _both_dbs(fake, tmp_path / "validation.lmdb", raw)
    for name in ("celeba_256", "celeba"):
        jcfg, tcfg = _configs(flags, dataset=name, data_dir=str(tmp_path))
        jds, tds = jdata.make_dataset(jcfg), tdata.make_dataset(tcfg)
        assert isinstance(tds, tlmdb.LMDBDataset) and len(tds) == len(jds) == 27000
        _assert_items(jds, tds, range(12))
    jt, tt = jdata.build_transform(jcfg), tdata.build_transform(tcfg)
    jds = jlmdb.LMDBDataset(str(tmp_path), name="celeba", train=False, transform=jt)
    tds = tlmdb.LMDBDataset(str(tmp_path), name="celeba", train=False, transform=tt)
    assert len(tds) == len(jds) == 3000
    _assert_items(jds, tds, range(3))
    for mod in (jlmdb, tlmdb):
        with pytest.raises(NotImplementedError, match="dataset lsun is unknown"):
            mod.num_samples("lsun", True)


def _cache_name(root):
    return "_cache_" + "".join(c for c in root if c in string.ascii_letters + string.digits)


@pytest.mark.parametrize("flags", TRANSFORMS, ids=["none", "resize_tensor_norm_crop"])
def test_lsun_over_three_classes_matches(tmp_path, fake, flags):
    """LSUN(classes=[three]) with 3, 2 and 4 entries under 40-hex keys: the
    cumulative index arithmetic, the targets (through target_transform),
    and each class's key cache, which the port writes as the JAX package
    does, byte for byte."""
    rs = np.random.RandomState(4)
    classes = ["church_outdoor_train", "bedroom_train", "tower_train"]
    roots = {}
    for c, n in zip(classes, (3, 2, 4)):
        items = {rs.bytes(20).hex().encode(): _encoded(rs, i) for i in range(n)}
        for pkg in ("jax", "port"):
            root = tmp_path / pkg / f"{c}_lmdb"
            _both_dbs(fake, root, items)
            roots[pkg, c] = root
    jcfg, tcfg = _configs(flags)
    jt, tt = jdata.build_transform(jcfg), tdata.build_transform(tcfg)
    jds = jlmdb.LSUN(str(tmp_path / "jax"), classes=classes, transform=jt,
                     target_transform=lambda t: 10 * t)
    tds = tlmdb.LSUN(str(tmp_path / "port"), classes=classes, transform=tt,
                     target_transform=lambda t: 10 * t)
    assert len(tds) == len(jds) == 9 and tds.indices == jds.indices == [3, 5, 9]
    _assert_items(jds, tds, range(9))
    assert [tds[i][1] for i in range(9)] == [0, 0, 0, 10, 10, 20, 20, 20, 20]
    for c in classes:
        jroot, troot = str(roots["jax", c]), str(roots["port", c])
        jcache = (roots["jax", c] / _cache_name(jroot)).read_bytes()
        tcache = (roots["port", c] / _cache_name(troot)).read_bytes()
        assert pickle.loads(jcache) == pickle.loads(tcache)
        assert tcache == pickle.dumps(pickle.loads(jcache))
    for ds in (jds, tds):
        assert ds._verify_classes("val") == [f"{c}_val" for c in ds.CATEGORIES]
        assert ds._verify_classes("test") == ["test"]
        with pytest.raises(ValueError, match="invalid classes"):
            ds._verify_classes(3)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lsun_key_cache_crosses_between_the_packages(tmp_path, fake, writer):
    """A cache that one package wrote is what the other reads: a cache
    whose key order is permuted (as a reader must take it, not rebuild it)
    orders the other package's items the same way."""
    rs = np.random.RandomState(6)
    root = tmp_path / "church_outdoor_train_lmdb"
    items = {rs.bytes(20).hex().encode(): _encoded(rs, i) for i in range(5)}
    _both_dbs(fake, root, items)
    first, second = (jlmdb, tlmdb) if writer == "jax" else (tlmdb, jlmdb)
    first.LSUNClass(str(root))
    cache = root / _cache_name(str(root))
    keys = pickle.loads(cache.read_bytes())
    assert keys == sorted(items) and all(isinstance(k, bytes) for k in keys)
    cache.write_bytes(pickle.dumps(keys[::-1]))
    other = second.LSUNClass(str(root))
    assert other.keys == keys[::-1] and len(other) == 5
    again = first.LSUNClass(str(root))
    jds, tds = (again, other) if second is tlmdb else (other, again)
    _assert_items(jds, tds, range(5))


def _webp(rs, i):
    """A WebP value as the LSUN release holds them (lossy RGB at several
    qualities and methods), and now and then a lossless or a grey one."""
    h, w = [(20, 26), (31, 17), (24, 24), (18, 22), (26, 20)][i % 5]
    arr = _smooth(rs, h, w, 3)
    im = Image.fromarray(arr[:, :, 0]) if i % 5 == 4 else Image.fromarray(arr)
    buf = io.BytesIO()
    im.save(buf, format="WEBP", quality=60 + 7 * (i % 6), method=i % 7, lossless=i % 5 == 3)
    return buf.getvalue()


def test_make_dataset_lsun_matches(tmp_path, fake):
    """make_dataset('lsun') reads data_dir/church_outdoor_train_lmdb (the
    default lsun_class) in both packages; an LSUN class of WebP values, the
    release's format, matches item for item."""
    rs = np.random.RandomState(8)
    items = {rs.bytes(20).hex().encode(): _encoded(rs, i) for i in range(4)}
    _both_dbs(fake, tmp_path / "church_outdoor_train_lmdb", items)
    jcfg, tcfg = _configs(TRANSFORMS[1], dataset="lsun", data_dir=str(tmp_path))
    jds, tds = jdata.make_dataset(jcfg), tdata.make_dataset(tcfg)
    assert isinstance(tds, tlmdb.LSUN) and tds.classes == ["church_outdoor_train"]
    _assert_items(jds, tds, range(4))
    webps = {rs.bytes(20).hex().encode(): _webp(rs, i) for i in range(10)}
    _both_dbs(fake, tmp_path / "tower_train_lmdb", webps)
    jt, tt = jdata.build_transform(jcfg), tdata.build_transform(tcfg)
    jds = jlmdb.LSUN(str(tmp_path), classes=["tower_train"], transform=jt)
    tds = tlmdb.LSUN(str(tmp_path), classes=["tower_train"], transform=tt)
    assert len(tds) == len(jds) == 10
    _assert_items(jds, tds, range(10))


@pytest.mark.parametrize("flags", TRANSFORMS, ids=["none", "resize_tensor_norm_crop"])
def test_celeba_lmdb_of_webp_values_matches(tmp_path, fake, flags):
    """LMDBDataset(is_encoded=True) on WebP values (make_dataset's
    celeba_256), item for item against the JAX package's."""
    rs = np.random.RandomState(9)
    _both_dbs(fake, tmp_path / "train.lmdb", {str(i).encode(): _webp(rs, i) for i in range(10)})
    jcfg, tcfg = _configs(flags, dataset="celeba_256", data_dir=str(tmp_path))
    jds, tds = jdata.make_dataset(jcfg), tdata.make_dataset(tcfg)
    assert isinstance(tds, tlmdb.LMDBDataset) and tds.is_encoded
    _assert_items(jds, tds, range(10))

"""The port's HDF5 reader and writer (``tdnet_torch/compat/hdf5.py``)
against ``h5py``: files that h5py writes with its defaults read back equal
(names, order, shapes, dtypes and values), and h5py reads every file the
port writes."""

import struct

import h5py
import numpy as np
import pytest

from tdnet_torch.compat import hdf5

DTYPES = ["f2", "f4", "f8", "i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8",
          ">f2", ">f4", ">f8", ">i2", ">i4", ">u8"]


def _array(rng, dtype, rank):
    shape = tuple(int(d) for d in rng.randint(1, 5, rank))
    if np.dtype(dtype).kind == "f":
        return (rng.standard_normal(shape) * 50).astype(dtype)
    info = np.iinfo(np.dtype(dtype))
    return rng.randint(max(info.min, -2**31), min(info.max, 2**31 - 1), shape,
                       dtype=np.int64).astype(dtype)


def _assert_same(got, want, name):
    assert got.shape == want.shape, name
    assert got.dtype == want.dtype, name
    np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.fixture(scope="module")
def h5py_file(tmp_path_factory):
    """h5py's defaults: every dtype at ranks 0-4, a compact dataset, an
    unwritten one with and without a fill value, a 300-member group (a
    two-level B-tree at libhdf5's K of 4 and 16), a dataset and a group
    whose headers move into a continuation block when attributes are added
    after their datasets, and a chunked dataset."""
    path = tmp_path_factory.mktemp("hdf5") / "h5py.h5"
    rng = np.random.RandomState(0)
    want = {}
    with h5py.File(path, "w") as f:
        typed = f.create_group("typed")
        for dtype in DTYPES:
            for rank in range(5):
                name = f"{dtype.replace('>', 'be_')}_rank{rank}"
                want["typed/" + name] = _array(rng, dtype, rank)
                typed.create_dataset(name, data=want["typed/" + name])
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        want["compact"] = rng.standard_normal((3, 5)).astype(np.float32)
        d = h5py.h5d.create(f.id, b"compact", h5py.h5t.IEEE_F32LE,
                            h5py.h5s.create_simple((3, 5)), dcpl)
        d.write(h5py.h5s.ALL, h5py.h5s.ALL, want["compact"])
        f.create_dataset("unwritten", shape=(2, 3), dtype="f4")
        want["unwritten"] = np.zeros((2, 3), np.float32)
        f.create_dataset("unwritten_fill", shape=(4,), dtype="i4", fillvalue=-7)
        want["unwritten_fill"] = np.full(4, -7, np.int32)
        big = f.create_group("big")
        for i in range(300):
            want[f"big/m{i:03d}"] = np.float32(i)
            big.create_dataset(f"m{i:03d}", data=np.float32(i))
        layer = f.create_group("layer")
        want["layer/kernel:0"] = rng.standard_normal((3, 3, 4, 8)).astype(np.float32)
        ds = layer.create_dataset("kernel:0", data=want["layer/kernel:0"])
        for i in range(30):
            ds.attrs[f"note{i}"] = np.arange(20) * i
            layer.attrs[f"note{i}"] = np.arange(20) * i
        layer.attrs["weight_names"] = np.array([b"kernel:0", b"bias:0"])
        want["layer/bias:0"] = np.arange(8, dtype=np.float32)
        layer.create_dataset("bias:0", data=want["layer/bias:0"])
        f.create_dataset("chunked", data=np.zeros((10, 10)), chunks=(5, 5))
    return path, want


def test_reader_equals_h5py(h5py_file):
    path, want = h5py_file
    with hdf5.File(path) as f, h5py.File(path, "r") as ref:
        assert list(f) == list(ref)
        for name, value in want.items():
            _assert_same(f[name].read(), np.asarray(ref[name]), name)
            np.testing.assert_array_equal(np.asarray(f[name]), value, err_msg=name)
        assert list(f["big"]) == list(ref["big"]) == sorted(f"m{i:03d}" for i in range(300))
        assert list(f["layer"]) == ["bias:0", "kernel:0"]  # attributes ignored


def _continuations(f, path):
    """Continuation messages in the header of the object at ``path``."""
    parent, _, name = path.rpartition("/")
    group = f[parent] if parent else f
    return sum(t == 0x10 for t, _, _ in _raw_messages(f._reader, group._entries[name][0]))


def _raw_messages(reader, addr):
    """Every message of an object header, continuations included."""
    prefix = reader.read(addr, 16)
    count, size = struct.unpack_from("<H", prefix, 2)[0], struct.unpack_from("<I", prefix, 8)[0]
    blocks, out = [(addr + 16, size)], []
    while blocks and len(out) < count:
        start, length = blocks.pop(0)
        buf, pos = reader.read(start, length), 0
        while pos + 8 <= length and len(out) < count:
            mtype, msize, flags = struct.unpack_from("<HHB", buf, pos)
            if mtype == 0x10:
                blocks.append(struct.unpack_from("<QQ", buf, pos + 8))
            out.append((mtype, flags, buf[pos + 8:pos + 8 + msize]))
            pos += 8 + msize
    return out


def test_reader_follows_continuations_and_deep_btrees(h5py_file):
    """The cases the fixture builds really are there: the 300-member
    group's B-tree has a level above its symbol nodes, and the dataset's
    and group's headers each continue in another block."""
    path, _ = h5py_file
    with hdf5.File(path) as f:
        btree = struct.unpack_from("<Q", [b for t, _, b in _raw_messages(
            f._reader, f._entries["big"][0]) if t == 0x11][0])[0]
        assert f._reader.read(btree, 8)[5] >= 1  # B-tree level
        for name in ("layer", "layer/kernel:0"):
            assert _continuations(f, name) >= 1, name


def test_reader_raises_naming_path_and_feature(h5py_file, tmp_path):
    path, _ = h5py_file
    with hdf5.File(path) as f:
        with pytest.raises(NotImplementedError, match="/chunked: a chunked layout"):
            f["chunked"]
        with pytest.raises(KeyError, match="/typed/missing"):
            f["typed/missing"]
    latest = tmp_path / "latest.h5"
    with h5py.File(latest, "w", libver="latest") as f:
        f.create_dataset("x", data=np.zeros(3))
    with pytest.raises(NotImplementedError, match="superblock version"):
        hdf5.File(latest)
    with h5py.File(tmp_path / "soft.h5", "w") as f:
        f.create_dataset("x", data=np.zeros(3))
        f["link"] = h5py.SoftLink("/x")
    with hdf5.File(tmp_path / "soft.h5") as f:
        with pytest.raises(NotImplementedError, match="/link: a soft link"):
            f["link"]
    (tmp_path / "not.h5").write_bytes(b"not an hdf5 file" * 40)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5.File(tmp_path / "not.h5")


def test_reader_takes_a_user_block(tmp_path):
    path = tmp_path / "ub.h5"
    with h5py.File(path, "w", userblock_size=1024) as f:
        f.create_dataset("g/x", data=np.arange(6.0).reshape(2, 3))
    with hdf5.File(path) as f:
        _assert_same(f["g/x"].read(), np.arange(6.0).reshape(2, 3), "g/x")


def _tree(rng):
    """Every dtype the writer takes, big-endian input too, ranks 0-4, an
    empty array, an empty group, names that sort differently as bytes and
    as text, and a 600-member group (several symbol nodes under one
    B-tree node)."""
    tree = {"typed": {}, "empty_group": {}, "names": {}, "wide": {}}
    for dtype in DTYPES:
        for rank in range(5):
            tree["typed"][f"{dtype.replace('>', 'be_')}_rank{rank}"] = _array(rng, dtype, rank)
    tree["typed"]["zero_size"] = np.zeros((0, 3), np.float32)
    for name in ("B", "a", "_x", "Z9", "kernel:0", "été", "a b"):
        tree["names"][name] = np.float64(len(name))
    for i in range(600):
        tree["wide"][f"w{i}"] = np.int64(i)
    tree["model_weights"] = {"conv1": {"conv1": {
        "kernel:0": rng.standard_normal((7, 7, 3, 64)).astype(np.float32)}}}
    return tree


def _walk_h5py(group, prefix=""):
    for key in group:
        item = group[key]
        if isinstance(item, h5py.Dataset):
            yield prefix + key, item[()]
        else:
            yield prefix + key + "/", None
            yield from _walk_h5py(item, prefix + key + "/")


def _flat(tree, prefix=""):
    for key in sorted(tree, key=lambda k: k.encode()):
        value = tree[key]
        if isinstance(value, dict):
            yield prefix + key + "/", None
            yield from _flat(value, prefix + key + "/")
        else:
            yield prefix + key, np.asarray(value)


def test_h5py_reads_what_the_writer_wrote(tmp_path):
    tree = _tree(np.random.RandomState(1))
    path = tmp_path / "port.h5"
    hdf5.write_hdf5(path, tree)
    with h5py.File(path, "r") as f:
        got = list(_walk_h5py(f))
    want = list(_flat(tree))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (name, g), (_, w) in zip(got, want):
        if w is None:
            continue
        assert g.shape == w.shape and g.dtype == w.dtype.newbyteorder("<"), name
        np.testing.assert_array_equal(g, w, err_msg=name)
    with hdf5.File(path) as f:
        for name, w in want:
            if w is not None:  # the writer stores little-endian
                _assert_same(f[name].read(), w.astype(w.dtype.newbyteorder("<")), name)


def test_writer_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(TypeError, match="integer and IEEE float"):
        hdf5.write_hdf5(tmp_path / "b.h5", {"b": np.array([True])})
    with pytest.raises(ValueError, match="bad HDF5 member name"):
        hdf5.write_hdf5(tmp_path / "s.h5", {"a/b": np.zeros(1)})

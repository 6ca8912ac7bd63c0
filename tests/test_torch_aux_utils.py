"""The port's host utilities against the JAX package's: the file cache
offline and over a loopback HTTP server (the same cache keys and sidecars,
no network), the profiling hooks on the CPU, the `utils/io.py` helpers,
`make_test_vocab` and `MetricsLogger.dump_config`."""
import json
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from test_aux import _EtagHandler
from xggm_tpu.data.tokenizer import make_test_vocab as jax_vocab
from xggm_tpu.training.metrics import MetricsLogger as JaxLogger
from xggm_tpu.utils import file_cache as jax_cache
from xggm_tpu.utils import io as jax_io
from xggm_tpu_torch.data.tokenizer import make_test_vocab
from xggm_tpu_torch.training.metrics import MetricsLogger
from xggm_tpu_torch.utils import file_cache, io
from xggm_tpu_torch.utils.profiling import StepTimer, annotate, trace


def test_file_cache_offline(tmp_path, monkeypatch):
    """No network: an unreachable URL falls back to the staged entry
    (`cache_put`, keyed by the URL alone); a true miss names the helper."""
    monkeypatch.setattr(file_cache, "_http_etag",
                        lambda url, timeout: (_ for _ in ()).throw(
                            OSError("network unreachable")))
    cache = str(tmp_path / "cache")
    src = tmp_path / "weights.bin"
    src.write_bytes(b"abc123")
    url = "https://example.com/bert/model.bin"
    with pytest.raises(FileNotFoundError,
                       match="xggm_tpu_torch.utils.file_cache.cache_put"):
        file_cache.cached_path(url, cache_dir=cache)
    staged = file_cache.cache_put(str(src), url, cache_dir=cache)
    assert os.path.basename(staged) == jax_cache.url_to_filename(url)
    assert json.load(open(staged + ".json")) == {"url": url, "etag": None}
    hit = file_cache.cached_path(url, cache_dir=cache)
    assert hit == staged and open(hit, "rb").read() == b"abc123"
    assert file_cache.cached_path(str(src), cache_dir=cache) == str(src)
    assert file_cache.cached_path(f"file://{src}", cache_dir=cache) == \
        str(src)
    with pytest.raises(FileNotFoundError):
        file_cache.cached_path(str(tmp_path / "absent"), cache_dir=cache)
    s3url = "s3://bucket/model.bin"  # no boto3 here: cache-only
    file_cache.cache_put(str(src), s3url, cache_dir=cache)
    assert open(file_cache.cached_path(s3url, cache_dir=cache),
                "rb").read() == b"abc123"
    for u, etag in ((url, None), (url, '"v1"'), (s3url, "x")):
        assert file_cache.url_to_filename(u, etag) == \
            jax_cache.url_to_filename(u, etag)
    # an archive extracts once, beside itself
    import tarfile
    with tarfile.open(tmp_path / "w.tar", "w") as tar:
        tar.add(src, arcname="weights.bin")
    dest = file_cache.extract_archive(str(tmp_path / "w.tar"))
    assert open(os.path.join(dest, "weights.bin"), "rb").read() == b"abc123"


def test_file_cache_http_download(tmp_path):
    """A download over a loopback server: the ETag-keyed entry and its
    sidecar as the JAX package writes them, a warm hit revalidates without
    a GET, a new ETag downloads again."""
    srv = _EtagHandler(b"weights-v1", etag='"v1"')
    try:
        got = file_cache.cached_path(srv.url, cache_dir=str(tmp_path / "p"))
        want = jax_cache.cached_path(srv.url, cache_dir=str(tmp_path / "j"))
        assert os.path.basename(got) == os.path.basename(want)
        assert open(got, "rb").read() == b"weights-v1"
        assert json.load(open(got + ".json")) == \
            json.load(open(want + ".json")) == {"url": srv.url,
                                                "etag": '"v1"'}
        assert (srv.head_count, srv.get_count) == (2, 2)
        assert file_cache.cached_path(srv.url,
                                      cache_dir=str(tmp_path / "p")) == got
        assert (srv.head_count, srv.get_count) == (3, 2)
        srv.payload, srv.etag = b"weights-v2", '"v2"'
        got2 = file_cache.cached_path(srv.url, cache_dir=str(tmp_path / "p"))
        assert got2 != got and open(got2, "rb").read() == b"weights-v2"
        assert srv.get_count == 3
    finally:
        srv.close()


def test_profiling_on_the_cpu(tmp_path):
    logdir = tmp_path / "trace"
    with trace(str(logdir)):
        with annotate("matmul"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    events = json.load(open(logdir / files[0]))["traceEvents"]
    assert any(e.get("name") == "matmul" for e in events)

    timer = StepTimer(window=3)
    assert timer.tick() is None and timer.mean == 0.0
    for _ in range(4):
        assert timer.sync_tick({"loss": torch.ones(2), "n": 3}) >= 0.0
    assert len(timer.times) == 3 and timer.steps_per_sec() > 0.0
    with pytest.raises(StopIteration):
        timer.sync_tick({"n": 3})  # no tensor to wait for


def test_io_vocab_and_config_dump_match_jax(tmp_path):
    obj = {"a": [1, 2], "b": np.arange(3)}
    io.save_pickle(obj, str(tmp_path / "p.pkl"))
    jax_io.save_pickle(obj, str(tmp_path / "j.pkl"))
    assert (tmp_path / "p.pkl").read_bytes() == (tmp_path / "j.pkl").read_bytes()
    got = io.load_pickle(str(tmp_path / "j.pkl"))
    assert got["a"] == [1, 2] and np.array_equal(got["b"], np.arange(3))
    # a Python 2 pickle of bytes that are not ASCII loads as latin-1
    (tmp_path / "py2.pkl").write_bytes(b"S'caf\\xe9'\np0\n.")
    assert io.load_pickle(str(tmp_path / "py2.pkl")) == \
        jax_io.load_pickle(str(tmp_path / "py2.pkl"))
    (tmp_path / "lines.txt").write_text("dog\ncat \n\nred")
    assert io.load_txt_lines(str(tmp_path / "lines.txt")) == \
        jax_io.load_txt_lines(str(tmp_path / "lines.txt")) == \
        ["dog", "cat ", "", "red"]
    import h5py
    with h5py.File(tmp_path / "obj.h5", "w") as f:
        f.create_group("img0").create_dataset("features", data=np.ones(3))
    with io.load_obj_h5(str(tmp_path / "obj.h5")) as f:
        assert list(f) == ["img0"] and f["img0"]["features"][()].sum() == 3

    for extra in ((), ("tree", "##s")):
        assert make_test_vocab(extra) == jax_vocab(extra)

    cfg = {"lr": 1e-4, "layers": [9, 5, 5], "path": tmp_path}
    # TensorBoard's writer imports TensorFlow, which the loggers can do
    # without here
    with mock.patch.dict(sys.modules, {"torch.utils.tensorboard": None}):
        for cls, sub in ((MetricsLogger, "port"), (JaxLogger, "jax")):
            cls(str(tmp_path / sub)).dump_config(cfg)
            cls(str(tmp_path / sub)).dump_config(cfg, name="other.json")
    for name in ("args.json", "other.json"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()
    MetricsLogger(None).dump_config(cfg)  # muted: writes nothing

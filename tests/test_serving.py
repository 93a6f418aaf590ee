"""Serving layer tests: micro-batching semantics and the HTTP surface."""

import io
import threading
import time
import urllib.request

import numpy as np
import pytest
from PIL import Image

import jax

from multi_style_transfer_gan.models import (
    enhanced_generator_apply, enhanced_generator_init,
)
from multi_style_transfer_gan.pipelines.model_loader import LoadedModel
from multi_style_transfer_gan.serving import (
    MicroBatcher, StyleTransferService, serve,
)


@pytest.fixture(scope="module")
def model():
    params = enhanced_generator_init(jax.random.PRNGKey(0), channels=4,
                                     num_transformer_blocks=1)
    return LoadedModel(kind="enhanced", channels=4, direction=None,
                       params=params,
                       apply=lambda x: enhanced_generator_apply(params, x),
                       precision="default")


def _png_bytes(w, h, seed=0):
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def test_microbatcher_batches_concurrent_requests():
    seen_shapes = []

    def run_fn(batch):
        seen_shapes.append(batch.shape)
        return batch + 1  # identity-ish: slot i gets its own canvas back

    b = MicroBatcher(run_fn, canvas=16, max_batch=4, max_wait_ms=50.0)
    try:
        canvases = [np.full((16, 16, 3), i, np.uint8) for i in range(6)]
        results = [None] * 6

        def post(i):
            results[i] = b.submit(canvases[i])

        threads = [threading.Thread(target=post, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # every request got ITS result (not a neighbor's slice)
        for i in range(6):
            np.testing.assert_array_equal(results[i], canvases[i] + 1)
        # fixed compiled shape, and 6 requests fit in <= 6 batches with
        # at least one real multi-request batch given the 50ms window
        assert set(seen_shapes) == {(4, 16, 16, 3)}
        assert b.batches >= 2 and b.images == 6
    finally:
        b.close()


def test_microbatcher_propagates_errors():
    def run_fn(batch):
        raise RuntimeError("kaboom")

    b = MicroBatcher(run_fn, canvas=8, max_batch=2, max_wait_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="kaboom"):
            b.submit(np.zeros((8, 8, 3), np.uint8))
    finally:
        b.close()


def test_http_server_end_to_end(model):
    service = StyleTransferService(model, canvas=64, max_batch=4,
                                   max_wait_ms=5.0, mode="cyclegan")
    server = serve(service, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    host, port = server.server_address
    try:
        # health + concurrent stylize posts
        assert urllib.request.urlopen(
            f"http://{host}:{port}/healthz").read() == b"ok"

        outs = [None] * 5

        def post(i):
            req = urllib.request.Request(
                f"http://{host}:{port}/stylize",
                data=_png_bytes(50, 40, seed=i), method="POST")
            outs[i] = urllib.request.urlopen(req).read()

        threads = [threading.Thread(target=post, args=(i,)) for i in range(5)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for data in outs:
            img = Image.open(io.BytesIO(data))
            assert img.size == (50, 40)  # aspect-restored (<=1MP source)

        import json
        stats = json.loads(urllib.request.urlopen(
            f"http://{host}:{port}/stats").read())
        assert stats["requests"] == 5 and stats["images"] >= 5

        # malformed body -> 400, not a dead server
        req = urllib.request.Request(f"http://{host}:{port}/stylize",
                                     data=b"not an image", method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req)
        assert ei.value.code == 400
    finally:
        server.shutdown()
        service.close()


def test_overload_shedding():
    from multi_style_transfer_gan.serving import Overloaded

    release = threading.Event()
    started = threading.Event()

    def run_fn(batch):
        started.set()
        assert release.wait(10)
        return batch

    b = MicroBatcher(run_fn, canvas=4, max_batch=2, max_wait_ms=2.0,
                     max_queue=2)
    try:
        results = {}

        def post(i):
            try:
                results[i] = b.submit(np.full((4, 4, 3), i, np.uint8),
                                      timeout=30)
            except Exception as e:
                results[i] = e

        threads = [threading.Thread(target=post, args=(i,)) for i in (1, 2, 3)]
        threads[0].start()
        assert started.wait(5)  # batch [1] dispatched, device "busy"
        for t in threads[1:]:
            t.start()
        time.sleep(0.2)  # 2 and 3 now occupy the bounded queue
        with pytest.raises(Overloaded):
            b.submit(np.full((4, 4, 3), 4, np.uint8))
        release.set()
        for t in threads:
            t.join(10)
        for i in (1, 2, 3):
            np.testing.assert_array_equal(results[i],
                                          np.full((4, 4, 3), i, np.uint8))
        assert b.shed == 1
    finally:
        b.close()


def test_abandoned_requests_are_skipped():
    release = threading.Event()
    started = threading.Event()

    def run_fn(batch):
        started.set()
        assert release.wait(10)
        return batch

    b = MicroBatcher(run_fn, canvas=4, max_batch=2, max_wait_ms=2.0)
    try:
        res1 = {}
        t1 = threading.Thread(target=lambda: res1.update(
            r=b.submit(np.ones((4, 4, 3), np.uint8), timeout=30)))
        t1.start()
        assert started.wait(5)
        # this requester gives up while its slot is still queued
        with pytest.raises(TimeoutError):
            b.submit(np.full((4, 4, 3), 2, np.uint8), timeout=0.05)
        release.set()
        t1.join(10)
        assert res1["r"] is not None
        # a later request still works and the abandoned slot was never
        # computed (images counts only delivered work)
        out = b.submit(np.full((4, 4, 3), 3, np.uint8), timeout=30)
        np.testing.assert_array_equal(out, np.full((4, 4, 3), 3, np.uint8))
        assert b.images == 2
    finally:
        b.close()


def test_http_multi_direction_routing(model):
    """Two services route by ?direction=; unknown direction -> 400."""
    params2 = enhanced_generator_init(jax.random.PRNGKey(9), channels=4,
                                      num_transformer_blocks=1)
    model2 = LoadedModel(kind="enhanced", channels=4, direction=None,
                         params=params2,
                         apply=lambda x: enhanced_generator_apply(params2, x),
                         precision="default")
    s1 = StyleTransferService(model, canvas=64, max_batch=2, max_wait_ms=2.0)
    s2 = StyleTransferService(model2, canvas=64, max_batch=2, max_wait_ms=2.0)
    server = serve({"photo2monet": s1, "monet2photo": s2}, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host, port = server.server_address
    try:
        body = _png_bytes(64, 64, seed=3)
        outs = {}
        for d in ("photo2monet", "monet2photo"):
            req = urllib.request.Request(
                f"http://{host}:{port}/stylize?direction={d}",
                data=body, method="POST")
            outs[d] = urllib.request.urlopen(req).read()
        # different weights -> different stylizations
        a = np.asarray(Image.open(io.BytesIO(outs["photo2monet"])), int)
        b = np.asarray(Image.open(io.BytesIO(outs["monet2photo"])), int)
        assert np.abs(a - b).mean() > 1.0

        # default (no param) routes to the first service
        req = urllib.request.Request(f"http://{host}:{port}/stylize",
                                     data=body, method="POST")
        urllib.request.urlopen(req).read()
        import json
        stats = json.loads(urllib.request.urlopen(
            f"http://{host}:{port}/stats").read())
        assert stats["photo2monet"]["requests"] == 2
        assert stats["monet2photo"]["requests"] == 1

        req = urllib.request.Request(
            f"http://{host}:{port}/stylize?direction=nope",
            data=body, method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req)
        assert ei.value.code == 400
    finally:
        server.shutdown()
        s1.close()
        s2.close()

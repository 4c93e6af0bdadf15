"""The port's hierarchical KV tiers and KV handoff
(``accelerate_tpu_torch/serving/tiers.py``, the engine's demote-on-evict /
restore paths and ``export_prefix_kv`` / ``import_prefix_kv``) on the CPU,
mirroring the reference's ``tests/test_kv_tiers.py`` (its classes
``TestRestoredHitExactness`` through ``TestUsageByteSeconds``) and held
against the JAX package's engine.

The contracts held:
- a restored hit gives the bits of a never-evicted hit (greedy and
  sampled, fp32 and int8 KV); greedy fp32 tokens also equal the reference
  engine's on the same weights;
- page and byte accounting survive 100 demote / restore cycles with no
  leak; no graph is captured after ``warmup()`` (the port's form of the
  reference's zero-recompile invariant: imports and restores copy into
  the arena in place);
- a torn or bit-flipped disk blob is rejected (deleted, counted) and the
  admission prefills cold;
- the peer tier pulls a warm prefix over the directory + export wire;
- the wire crosses: a handoff exported by the reference's engine imports
  into the port's and the reverse, at fp32, bf16 and int8, the installed
  pages bit-equal to the sender's bytes and the greedy tokens equal; disk
  blobs are read in both directions; a tampered leaf path, shape or dtype
  is rejected with a ``ValueError`` as the reference rejects it;
- the tier store's bookkeeping, blobs and gauges equal the reference
  store's on one put / probe sequence, and the prefix cache's ghost
  gauges equal the reference cache's on one trace.

The JAX engine runs its Pallas kernels in the interpreter, as its own
tests do; the port's engine runs the kernels' plain versions.
"""

import base64
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.serving import ServingEngine as JaxEngine
from accelerate_tpu.serving import pages as jax_pages
from accelerate_tpu.serving import tiers as jax_tiers
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.ops import kernels
from accelerate_tpu_torch.serving import pages
from accelerate_tpu_torch.serving.engine import ServingEngine
from accelerate_tpu_torch.serving.tiers import (
    BLOB_SUFFIX,
    TierConfig,
    TieredStore,
    TierEntry,
    _digest,
    entry_nbytes,
    entry_to_handoff,
    handoff_to_entry,
)
from accelerate_tpu_torch.telemetry import TelemetryConfig, TelemetrySession
from accelerate_tpu_torch.telemetry.usage import UsageAccountant
from accelerate_tpu_torch.utils import cuda_graphs

PS = 8
DTYPES = {"fp32": (jnp.float32, torch.float32, None),
          "bf16": (jnp.bfloat16, torch.bfloat16, None),
          "int8": (jnp.float32, torch.float32, "int8")}


def _pair(dtype="fp32"):
    """(reference model, its params, the port's model on the same weights,
    the engines' kv_cache_dtype) at ``DecoderConfig.tiny`` with 2 kv heads."""
    jd, td, kv = DTYPES[dtype]
    jcfg = JaxConfig.tiny(num_kv_heads=2, max_seq_len=64, dtype=jd,
                          decode_kernel="interpret", prefill_kernel="interpret")
    jmodel = JaxLM(jcfg)
    params, _ = unbox_params(
        jmodel.init_variables(jax.random.PRNGKey(0), batch_size=1, seq_len=16)["params"])
    cfg = DecoderConfig.tiny(num_kv_heads=2, max_seq_len=64, dtype=td)
    model = DecoderLM(cfg, device="cpu").load_params(
        from_reference(jax.tree_util.tree_map(np.asarray, params), cfg))
    return jmodel, params, model, kv


@pytest.fixture(scope="module")
def models():
    return _pair("fp32")


def _kw(kw):
    kw = dict(kw)
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_cache_len", 64)
    kw.setdefault("prefill_chunks", (4, 8))
    kw.setdefault("page_size", PS)
    return kw


def _engine(models, **kw):
    return ServingEngine(models[2], device="cpu", **_kw(kw))


def _jax_engine(models, **kw):
    return JaxEngine(models[0], models[1], **_kw(kw))


def _prompt(seed, n=12):
    return np.random.RandomState(seed).randint(3, 256, (n,))


def _run(engine, prompt, new, seed=0, **kw):
    req = engine.submit(prompt, max_new_tokens=new, seed=seed, **kw)
    engine.run()
    assert req.outcome == "finished", (req.outcome, req.shed_reason)
    return req


def _evict_all(engine):
    """Force-demote everything the HBM prefix cache holds."""
    while engine._prefix.evict_lru():
        pass


def _cold(models, prompt, new, seed=0, **kw):
    """The request served alone on a fresh tierless engine."""
    return _run(_engine(models, **kw), prompt, new, seed).tokens


# ---------------------------------------------------------------------------
# the reference's classes, on the port
# ---------------------------------------------------------------------------


class TestRestoredHitExactness:
    @pytest.mark.parametrize("temperature,top_k,kv_dtype",
                             [(0.0, None, None), (1.0, 8, None), (0.0, None, "int8"),
                              (1.0, 8, "int8")],
                             ids=["greedy", "sampled", "greedy-int8", "sampled-int8"])
    def test_restore_from_host_bit_identical(self, models, temperature, top_k, kv_dtype):
        """Warm a prompt, evict it into the host tier, resubmit: the
        admission restores from host, and its tokens are those of a
        never-evicted hit on a twin engine (quantized pages travel
        verbatim). Greedy fp32: also the reference engine's tokens."""
        kw = dict(temperature=temperature, top_k=top_k, kv_cache_dtype=kv_dtype)
        p = _prompt(7)
        warm = _engine(models, **kw)
        _run(warm, p, 2, seed=3)
        ref_req = _run(warm, p, 6, seed=3)
        assert ref_req.prefix_hit >= PS
        engine = _engine(models, kv_tiers=TierConfig(host_entries=8), **kw)
        _run(engine, p, 2, seed=3)
        _evict_all(engine)
        assert engine._tiers.demotions_host >= 1
        assert engine.metrics()["serving/kv_host_entries"] >= 1
        req = _run(engine, p, 6, seed=3)
        assert req.tokens == ref_req.tokens
        if temperature == 0.0 and kv_dtype is None:
            jeng = _jax_engine(models, kv_tiers=jax_tiers.TierConfig(host_entries=8))
            jeng.submit(p, max_new_tokens=2, seed=3)
            jeng.run()
            while jeng._prefix.evict_lru():
                pass
            jreq = jeng.submit(p, max_new_tokens=6, seed=3)
            jeng.run()
            assert req.tokens == [int(t) for t in jreq.tokens]
            assert (req.kv_restore_tier, req.kv_restore_pages, req.prefix_hit) == \
                (jreq.kv_restore_tier, jreq.kv_restore_pages, jreq.prefix_hit)
        assert req.kv_restore_tier == "host"
        assert req.kv_restore_pages >= 1 and req.kv_restore_ms > 0
        assert req.prefix_hit >= PS
        assert engine.kv_tier_hits["host"] == 1
        m = engine.metrics()
        assert m["serving/kv_restores"] == 1
        assert m["serving/kv_tier_hit_ratio_host"] > 0

    def test_restore_from_disk_and_durability(self, models, tmp_path):
        """Host overflow cascades to disk; a fresh store over the same
        directory (a restarted replica) still serves the restore."""
        disk_dir = str(tmp_path / "kv")
        tiers = dict(host_entries=1, disk_entries=8, disk_dir=disk_dir)
        engine = _engine(models, kv_tiers=TierConfig(**tiers))
        prompts = [_prompt(8 + i) for i in range(3)]
        for i, p in enumerate(prompts):
            _run(engine, p, 2, seed=i)
        _evict_all(engine)
        assert engine._tiers.demotions_disk >= 1
        assert any(n.endswith(BLOB_SUFFIX) for n in os.listdir(disk_dir))
        engine2 = _engine(models, kv_tiers=TierConfig(**tiers))
        assert len(engine2._tiers.disk.entries) >= 1
        hit_any = False
        for i, p in enumerate(prompts):
            req = _run(engine2, p, 6, seed=i)
            assert req.tokens == _cold(models, p, 6, seed=i)
            hit_any = hit_any or req.kv_restore_tier == "disk"
        assert hit_any


class TestLeakBaseline:
    def test_100_demote_restore_cycles_no_leak(self, models):
        """Churn demote / restore 100 times: the allocator's free list ends
        where it started and the tier bytes drain to 0."""
        held = {"host": 0, "disk": 0}
        engine = _engine(models, kv_tiers=TierConfig(host_entries=16))
        engine._tiers.on_bytes = lambda tenant, tier, delta: held.__setitem__(
            tier, held[tier] + delta)
        free0 = engine._allocator.free_count
        prompts = [np.random.RandomState(9 + i).randint(3, 256, (10 + (i % 3),))
                   for i in range(5)]
        for i in range(100):
            _run(engine, prompts[i % 5], 1, seed=i % 5)
            if i % 2 == 1:
                _evict_all(engine)  # demote; the next submit restores
        assert engine.requests_completed == 100
        assert engine.kv_restores >= 10 and engine._tiers.demotions_host >= 10
        _evict_all(engine)
        assert engine._allocator.in_use == 0 and engine._allocator.free_count == free0
        engine._tiers.clear()
        assert held == {"host": 0, "disk": 0}
        assert engine.metrics()["serving/kv_host_bytes"] == 0


@pytest.fixture
def graphs(monkeypatch):
    """The engine's CUDA branch on the CPU: ``cuda_graphs.capture`` stubbed
    to a step that counts its captures and replays the body eagerly."""
    captured = []

    class Step:
        def __init__(self, body, device, restore=()):
            self.body, self.seconds = body, 0.0
            captured.append(self)

        def replay(self):
            return self.body()

    monkeypatch.setattr(cuda_graphs, "capture", Step)
    monkeypatch.setattr(kernels, "build", lambda names=None: None)
    return captured


class TestZeroRecompile:
    @pytest.mark.parametrize("kv_dtype", [None, "int8"])
    def test_tiering_captures_nothing_after_warmup(self, models, graphs, kv_dtype):
        """After ``warmup()``, demotions, restores and an import capture no
        graph: they copy into the pages the captured step already reads
        (the arena's tensors keep their addresses), and the restored
        admissions decode through that one graph."""
        engine = _engine(models, kv_tiers=TierConfig(host_entries=8), kv_cache_dtype=kv_dtype)
        engine.device = torch.device("cuda")
        engine.warmup()
        engine.device = torch.device("cpu")
        assert len(graphs) == 1
        ptrs = [leaf.data_ptr() for layer in engine._arena for leaf in layer.values()]
        prompts = [_prompt(10, n) for n in (12, 11, 10)]
        for i, p in enumerate(prompts):
            _run(engine, p, 2, seed=i)
        _evict_all(engine)
        assert engine._tiers.demotions_host >= 1
        reqs = [engine.submit(p, max_new_tokens=3, seed=i) for i, p in enumerate(prompts)]
        engine.run()
        assert all(r.outcome == "finished" for r in reqs)
        assert engine.kv_restores >= 1
        donor = _engine(models, kv_cache_dtype=kv_dtype)
        _run(donor, _prompt(11), 2)
        assert engine.import_prefix_kv(donor.export_prefix_kv(_prompt(11))) == 12
        _run(engine, _prompt(11), 3)
        assert len(graphs) == 1
        assert [leaf.data_ptr() for layer in engine._arena for leaf in layer.values()] == ptrs


def _store_entry(key_tokens, n_pages=2, ps=PS, dtype=np.float32):
    tokens = np.asarray(key_tokens, np.int32)
    rng = np.random.RandomState(int(tokens.sum()) % 100)
    arrays = [rng.rand(n_pages, 2, ps, 4).astype(dtype)]
    return TierEntry(key=_digest(tokens), token_len=int(tokens.size), tokens=tokens,
                     n_pages=n_pages, arrays=arrays, paths=["k0"],
                     nbytes=entry_nbytes(arrays, tokens))


class TestDiskBlobIntegrity:
    def _store(self, tmp_path, **kw):
        kw.setdefault("host_entries", 1)
        kw.setdefault("disk_entries", 8)
        return TieredStore(TierConfig(disk_dir=str(tmp_path / "kv"), **kw), page_size=PS)

    def _demote_two(self, store):
        e1 = _store_entry(np.arange(3, 19))
        store.put(e1)                          # host
        store.put(_store_entry(np.arange(40, 56)))  # host overflows: e1 to disk
        assert store.demotions_disk == 1
        return e1

    def _blob(self, store):
        [blob] = [os.path.join(store.config.disk_dir, n)
                  for n in os.listdir(store.config.disk_dir)]
        return blob

    def test_truncated_blob_rejected_and_deleted(self, tmp_path):
        store = self._store(tmp_path)
        e1 = self._demote_two(store)
        blob = self._blob(store)
        with open(blob, "r+") as fh:
            fh.truncate(os.path.getsize(blob) // 2)  # torn write
        assert store.probe(e1.tokens) is None
        assert store.disk_corrupt_dropped == 1
        assert not os.path.exists(blob) and len(store.disk.entries) == 0

    def test_bitflipped_blob_fails_checksum(self, tmp_path):
        store = self._store(tmp_path)
        e1 = self._demote_two(store)
        blob = self._blob(store)
        with open(blob) as fh:
            doc = json.load(fh)
        data = doc["leaves"][0]["data"]
        doc["leaves"][0]["data"] = ("B" if data[0] == "A" else "A") + data[1:]
        with open(blob, "w") as fh:
            json.dump(doc, fh)  # the checksum is now stale: a bit flip
        assert store.probe(e1.tokens) is None
        assert store.disk_corrupt_dropped == 1 and not os.path.exists(blob)

    def test_corrupt_blob_cold_fallback_end_to_end(self, models, tmp_path):
        """A corrupt blob neither crashes the engine nor moves its tokens:
        the admission pays the cold prefill."""
        disk_dir = str(tmp_path / "kv")
        engine = _engine(models, kv_tiers=TierConfig(host_entries=1, disk_entries=8,
                                                     disk_dir=disk_dir))
        prompts = [_prompt(11 + i) for i in range(3)]
        for i, p in enumerate(prompts):
            _run(engine, p, 2, seed=i)
        _evict_all(engine)
        for name in os.listdir(disk_dir):
            with open(os.path.join(disk_dir, name), "r+") as fh:
                fh.truncate(10)
        engine._tiers.host.entries.clear()
        engine._tiers.host.index.clear()
        for i, p in enumerate(prompts):
            req = _run(engine, p, 6, seed=i)
            assert req.tokens == _cold(models, p, 6, seed=i)
            assert req.kv_restore_tier is None  # cold, not corrupt-restored
        assert engine._tiers.disk_corrupt_dropped >= 1
        assert engine.metrics()["serving/kv_disk_corrupt_dropped"] >= 1


class TestPeerTier:
    def test_pull_between_two_engines(self, models):
        """Engine B misses; its peer tier pulls A's warm prefix through the
        directory + export wire (an injected fetch, no sockets) and the
        restored output equals a cold run. Export / import gauges count the
        pages that moved."""
        a = _engine(models)
        p = _prompt(12)
        _run(a, p, 2, seed=5)

        def fetch(url, path, payload=None, timeout_s=None):
            assert url == "http://peer-a"
            if path == "/v1/kv/directory":
                return a.kv_directory()
            if path == "/v1/kv/export":
                return json.loads(json.dumps(a.export_prefix_kv(payload["tokens"])))
            raise AssertionError(path)

        b = _engine(models, kv_tiers=TierConfig(host_entries=4,
                                                peers=(("a", "http://peer-a"),)))
        b._tiers._fetch = fetch
        req = _run(b, p, 6, seed=5)
        assert req.tokens == _cold(models, p, 6, seed=5)
        assert req.kv_restore_tier == "peer"
        assert b.kv_tier_hits["peer"] == 1
        assert a.kv_pages_exported == b.kv_pages_imported == req.kv_restore_pages >= 1
        assert b._tiers.peer_pulls == 1
        m = b.metrics()
        assert m["serving/kv_peer_pulls"] == 1 and m["serving/kv_pages_imported"] >= 1

    def test_stale_directory_counts_failure_and_falls_back(self, models):
        p = _prompt(13)

        def fetch(url, path, payload=None, timeout_s=None):
            if path == "/v1/kv/directory":
                # advertised, but the export fails: evicted since
                return {"prefixes": [{"digest": _digest(np.asarray(p[:n], np.int32)).hex(),
                                      "token_len": n} for n in (8, 11)]}
            return None

        b = _engine(models, kv_tiers=TierConfig(host_entries=4,
                                                peers=(("a", "http://peer-a"),)))
        b._tiers._fetch = fetch
        req = _run(b, p, 6, seed=5)
        assert req.tokens == _cold(models, p, 6, seed=5)
        assert req.kv_restore_tier is None
        assert b._tiers.peer_pull_failures >= 1


class TestTierFormat:
    def test_handoff_round_trip_preserves_bytes(self):
        e = _store_entry(np.arange(3, 19))
        back = handoff_to_entry(entry_to_handoff(e, page_size=PS, kv_cache_dtype="bf16"))
        assert back.key == e.key and back.token_len == e.token_len
        np.testing.assert_array_equal(back.tokens, e.tokens)
        for x, y in zip(back.arrays, e.arrays):
            np.testing.assert_array_equal(x, y)

    def test_bf16_travels_as_its_raw_words(self):
        """A bf16 leaf is a uint16 array named "bfloat16" on the wire; the
        reference decodes it (through ml_dtypes) to the same values."""
        words = torch.randn(1, 2, 2, PS, 4).to(torch.bfloat16)
        tokens = np.arange(3, 19, dtype=np.int32)
        arrays = [words.view(torch.uint16).numpy()]
        e = TierEntry(key=_digest(tokens), token_len=16, tokens=tokens, n_pages=2,
                      arrays=arrays, paths=["k0"], nbytes=entry_nbytes(arrays, tokens),
                      dtypes=["bfloat16"])
        doc = entry_to_handoff(e, page_size=PS, kv_cache_dtype="bf16")
        assert doc["leaves"][0]["dtype"] == "bfloat16"
        back = handoff_to_entry(json.loads(json.dumps(doc)))
        assert back.arrays[0].dtype == np.uint16 and back.dtype_names() == ["bfloat16"]
        np.testing.assert_array_equal(back.arrays[0], arrays[0])
        ref = jax_tiers.handoff_to_entry(doc)
        np.testing.assert_array_equal(np.asarray(ref.arrays[0], np.float32),
                                      words.float().numpy())

    def test_prefix_slicing_serves_shorter_lengths(self):
        """One long demoted entry serves its aligned shorter prefixes."""
        store = TieredStore(TierConfig(host_entries=4), page_size=PS)
        e = _store_entry(np.arange(3, 19))  # 16 tokens, 2 pages
        store.put(e)
        hit = store.probe(e.tokens[:PS], min_len=0)
        assert hit is not None and hit["tier"] == "host" and hit["token_len"] == PS
        assert hit["arrays"][0].shape[0] == 1
        np.testing.assert_array_equal(hit["arrays"][0], e.arrays[0][:1])
        assert store.covers(_digest(e.tokens[:PS]))

    def test_min_len_excludes_hits_hbm_already_serves(self):
        store = TieredStore(TierConfig(host_entries=4), page_size=PS)
        e = _store_entry(np.arange(3, 19))
        store.put(e)
        assert store.probe(e.tokens, min_len=16) is None
        assert store.probe(e.tokens, min_len=8)["token_len"] == 16


class TestUsageByteSeconds:
    def test_tier_byte_seconds_accrue_and_drain(self):
        t = [0.0]
        u = UsageAccountant(clock=lambda: t[0])
        u.note_tier_bytes("acme", "host", 1000)
        t[0] = 2.0
        u.note_tier_bytes("acme", "host", -1000)
        u.note_tier_bytes("acme", "disk", 500)
        t[0] = 6.0
        u.note_tier_bytes("acme", "disk", -500)
        totals = u.totals()
        assert totals["host_byte_seconds"] == pytest.approx(2000.0)
        assert totals["disk_byte_seconds"] == pytest.approx(2000.0)
        snap = u.snapshot()["tenants"]["acme"]
        assert snap["host_bytes_held"] == 0 and snap["disk_bytes_held"] == 0
        u.note_tier_bytes("acme", "host", -999)  # an unmatched release clamps
        assert u.snapshot()["tenants"]["acme"]["host_bytes_held"] == 0

    def test_engine_wires_store_bytes_to_usage(self, models, tmp_path):
        session = TelemetrySession(TelemetryConfig(trace_dir=str(tmp_path),
                                                   flight_hooks=False, timeline_interval_s=0))
        try:
            engine = _engine(models, telemetry=session, kv_tiers=TierConfig(host_entries=8))
            _run(engine, _prompt(14), 2, tenant="acme")
            _evict_all(engine)
            held = session.usage.snapshot()["tenants"]["acme"]["host_bytes_held"]
            assert held == engine._tiers.host.nbytes > 0
            engine._tiers.clear()
            assert session.usage.snapshot()["tenants"]["acme"]["host_bytes_held"] == 0
        finally:
            session.close()


# ---------------------------------------------------------------------------
# the wire between the reference and the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=sorted(DTYPES))
def dtype_pair(request):
    return request.param, _pair(request.param)


def _leaf_bytes(handoff):
    return [(leaf["path"], leaf["dtype"], leaf["shape"], leaf["data"])
            for leaf in handoff["leaves"]]


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_handoff_crosses_the_wire(dtype_pair, direction):
    """One side serves a prompt and exports its prefix; the JSON crosses to
    the other side, which imports it: its arena then holds the sender's
    bytes bit for bit (re-exported, leaf for leaf), and its greedy tokens
    on that prompt equal the sender's warm hit."""
    name, pair = dtype_pair
    kv = pair[3]
    p = _prompt(20, 20)  # 2 full pages and a partial one at page 8
    engines = {"port": _engine(pair, kv_cache_dtype=kv),
               "reference": _jax_engine(pair, kv_cache_dtype=kv)}
    src, dst = direction.split("_to_")
    sender, receiver = engines[src], engines[dst]
    sender.submit(p, max_new_tokens=2)
    sender.run()
    warm = sender.submit(p, max_new_tokens=6)
    sender.run()
    handoff = json.loads(json.dumps(sender.export_prefix_kv(p)))
    assert (handoff["token_len"], handoff["n_pages"]) == (20, 3)
    assert [leaf["dtype"] for leaf in handoff["leaves"]] == \
        (["bfloat16"] * 2 if name == "bf16" else ["float32"] * 2 if kv is None
         else ["int8", "float32", "int8", "float32"])
    assert receiver.import_prefix_kv(handoff) == 20
    assert _leaf_bytes(json.loads(json.dumps(receiver.export_prefix_kv(p)))) == \
        _leaf_bytes(handoff)
    got = receiver.submit(p, max_new_tokens=6)
    receiver.run()
    assert got.prefix_hit == warm.prefix_hit == 16
    assert [int(t) for t in got.tokens] == [int(t) for t in warm.tokens]
    assert receiver.kv_pages_imported == 3


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_disk_blobs_cross(tmp_path, direction):
    """One side's engine demotes a prefix to a disk blob; the other side's
    engine, over the same directory, restores from it and gives the
    tokens of a never-evicted hit."""
    pair = _pair("bf16")
    disk = str(tmp_path / "kv")
    p = _prompt(21, 20)
    build = {"port": lambda: _engine(pair, kv_tiers=TierConfig(
                 host_entries=1, disk_entries=4, disk_dir=disk)),
             "reference": lambda: _jax_engine(pair, kv_tiers=jax_tiers.TierConfig(
                 host_entries=1, disk_entries=4, disk_dir=disk))}
    src, dst = direction.split("_to_")
    writer = build[src]()
    writer.submit(p, max_new_tokens=2)
    writer.run()
    warm = writer.submit(p, max_new_tokens=6)
    writer.run()
    writer.submit(_prompt(22, 20), max_new_tokens=1)
    writer.run()
    while writer._prefix.evict_lru():
        pass
    assert writer._tiers.demotions_disk >= 1
    reader = build[dst]()
    assert len(reader._tiers.disk.entries) >= 1 and reader._tiers.disk_corrupt_dropped == 0
    got = reader.submit(p, max_new_tokens=6)
    reader.run()
    assert got.kv_restore_tier == "disk"
    assert [int(t) for t in got.tokens] == [int(t) for t in warm.tokens]


@pytest.mark.parametrize("field", ["path", "shape", "dtype"])
def test_tampered_leaf_is_rejected_like_the_reference(models, field):
    """A handoff whose leaf path, shape or dtype does not match the arena is
    refused with the reference's ValueError on both sides, and nothing is
    installed."""
    a = _engine(models)
    p = _prompt(23)
    _run(a, p, 2)
    handoff = json.loads(json.dumps(a.export_prefix_kv(p)))
    leaf = handoff["leaves"][0]
    if field == "path":
        leaf["path"] = "['layers']['block']['attn']['cached_query']"
    elif field == "shape":
        leaf["shape"] = [leaf["shape"][0], leaf["shape"][1], leaf["shape"][2] * 2,
                         leaf["shape"][3] // 2, leaf["shape"][4]]
    else:
        raw = base64.b64decode(leaf["data"])
        leaf["dtype"] = "float16"  # the same element count in half the bytes
        leaf["data"] = base64.b64encode(raw[: len(raw) // 2]).decode("ascii")
    for eng in (_engine(models), _jax_engine(models)):
        free = eng._allocator.free_count
        with pytest.raises(ValueError, match="does not match engine leaf"):
            eng.import_prefix_kv(handoff)
        assert eng._allocator.free_count == free and not eng._prefix.entries
    for key, value, match in (("page_size", 16, "page_size"), ("kv_cache_dtype", "int8",
                                                                 "kv_cache_dtype"),
                              ("leaves", handoff["leaves"][:-1], "leaves")):
        with pytest.raises(ValueError, match=match):
            _engine(models).import_prefix_kv(dict(handoff, **{key: value}))


def test_tier_store_matches_the_reference_store(tmp_path):
    """One put / probe / overflow sequence on the port's store and the
    reference's: the same demotions, blobs byte for byte, probe answers,
    checksums and gauges."""
    sides = {}
    for side, mod in (("port", None), ("reference", jax_tiers)):
        tiers = mod or __import__("accelerate_tpu_torch.serving.tiers", fromlist=["x"])
        digest = jax_pages._digest if mod else _digest
        store = tiers.TieredStore(tiers.TierConfig(host_entries=2, disk_entries=2,
                                                   disk_dir=str(tmp_path / side)),
                                  page_size=PS, replica="r")
        probes = []
        for i in range(6):
            toks = np.arange(3 + 20 * i, 3 + 20 * i + 12 + i, dtype=np.int32)
            arrays = [np.random.RandomState(i).rand(1 + (toks.size > PS), 2, PS, 4)
                      .astype(np.float32)]
            store.put(tiers.TierEntry(key=digest(toks), token_len=int(toks.size),
                                      tokens=toks, n_pages=arrays[0].shape[0],
                                      arrays=arrays, paths=["k"],
                                      nbytes=tiers.entry_nbytes(arrays, toks)))
            hit = store.probe(np.arange(3 + 20 * (i // 2), 3 + 20 * (i // 2) + 30))
            probes.append(None if hit is None else (hit["tier"], hit["token_len"],
                                                    [a.tobytes() for a in hit["arrays"]]))
        blobs = sorted((n, open(os.path.join(tmp_path, side, n), "rb").read())
                       for n in os.listdir(tmp_path / side))
        sides[side] = (probes, blobs, store.gauges())
    assert sides["port"] == sides["reference"]


def test_ghost_gauges_match_the_reference_cache():
    """The prefix cache's ghost shadows and reuse distances, driven by one
    lookup / insert / evict trace beside the reference's cache."""
    caches = []
    for mod in (pages, jax_pages):
        cache = mod.PrefixCache(mod.PageAllocator(64), PS, max_entries=3)
        caches.append(cache)
        rng = np.random.RandomState(0)
        for i in range(60):
            prompt = np.concatenate([np.arange(10 * (i % 7), 10 * (i % 7) + 8),
                                     rng.randint(3, 256, (rng.randint(1, 12),))])
            hit, entry = cache.lookup(prompt, limit=prompt.size - 1)
            cache.record_hit(hit, entry)
            held = [cache.allocator.alloc() for _ in range(-(-prompt.size // PS))]
            cache.insert(prompt, held, tenant=f"t{i % 2}")
            for page in held:  # the entries hold their own references
                cache.allocator.release(page)
    assert caches[0].ghost.gauges() == caches[1].ghost.gauges()
    assert (caches[0].hits, caches[0].lookups) == (caches[1].hits, caches[1].lookups)
    assert [(e.token_len, e.tenant) for e in caches[0].entries.values()] == \
        [(e.token_len, e.tenant) for e in caches[1].entries.values()]


def test_evicting_one_entry_by_key_demotes_and_releases_it():
    """``PrefixCache.evict(key)`` drops the entry it names as LRU eviction
    drops its victim: offered to the demote hook with its pages still held,
    then its page references released; the other entries stay."""
    allocator = pages.PageAllocator(16)
    demoted = []
    cache = pages.PrefixCache(allocator, PS, max_entries=8,
                              on_evict=lambda e: demoted.append(
                                  (e.token_len, [allocator.shared(p) for p in e.pages])))
    prompt = np.arange(3, 3 + 2 * PS + 1, dtype=np.int32)
    held = [allocator.alloc() for _ in range(3)]
    cache.insert(prompt, held)
    for page in held:
        allocator.release(page)
    in_use = allocator.in_use
    deep = next(k for k, e in cache.entries.items() if e.token_len == prompt.size)
    cache.evict(deep)
    assert demoted == [(prompt.size, [True, True, False])]
    assert sorted(e.token_len for e in cache.entries.values()) == [PS, 2 * PS]
    assert allocator.in_use == in_use - 1
    assert cache.peek(prompt) == (2 * PS, cache.entries[next(
        k for k, e in cache.entries.items() if e.token_len == 2 * PS)])

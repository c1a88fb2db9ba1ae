"""The slice as a whole: the config-4 program (``bench.py``
``config4_streaming_engine``, cut to 512 docs and the small test encoder)
through both packages. Docs stream through an ``InMemoryKafkaBroker``,
the embed UDF runs deferred and blocking, ``DataIndex.query_as_of_now``
answers a static query table, and ``subscribe`` collects the embedded
rows. The final ``embedded`` tables have JAX's row ids; each package's
engine vectors equal its own model's direct output exactly (the engine adds
no error), and the port's are within the encoders' cross-framework f32
tolerance of JAX's (``atol=1e-4``, as in ``tests/test_torch_transformer.py``:
one text of these 512 differs by 3.0e-5 in one component between the two
encoders called directly, outside the engine). The replies of
``DataIndex.query`` over the same texts are JAX's. A subprocess runs the program with ``pandas`` and
``xxhash`` blocked. Every wait is bounded by a deadline."""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

import pathway_tpu as JPW
import pathway_tpu_torch as TPW
from pathway_tpu.models.embedder import SentenceEmbedderModel as JEmbed
from pathway_tpu.models.tokenizer import HashTokenizer as JTok
from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as JSTE
from pathway_tpu_torch.engine.value import hash_values
from pathway_tpu_torch.models.embedder import SentenceEmbedderModel
from pathway_tpu_torch.models.params import from_jax_params
from pathway_tpu_torch.models.tokenizer import HashTokenizer
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
from tests.torch_engine import canon, final_state
from tests.torch_parity import configs, np_encoder_params, to_jax

N_DOCS, VOCAB, MAX_LEN, K = 512, 1000, 64, 10
WORDS = ["alpha", "beta", "gamma", "delta", "stream", "tensor", "index"]
QUERIES = ["alpha stream tensor", "delta index beta"]
NPP = np_encoder_params(seed=4)


def _texts(n=N_DOCS, seed=11):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, 24)) for _ in range(n)]


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = configs("float32")
    jm = JEmbed(jcfg, params=to_jax(NPP),
                tokenizer=JTok(vocab_size=VOCAB, max_length=MAX_LEN), max_length=MAX_LEN)
    tm = SentenceEmbedderModel(tcfg, params=from_jax_params(NPP),
                               tokenizer=HashTokenizer(vocab_size=VOCAB, max_length=MAX_LEN),
                               max_length=MAX_LEN, device="cpu")
    yield {"jax": jm, "torch": tm}
    jm.close()
    tm.close()


def _embedder(pkg, model, deferred):
    cls = SentenceTransformerEmbedder if pkg == "torch" else JSTE
    return cls(model, max_batch_size=128, deferred=deferred)


def _knn(pkg, pw, column, **kw):
    if pkg == "torch":
        kw["device"] = "cpu"
    return pw.indexing.BruteForceKnn(column, dimensions=32, metric="cos", **kw)


def _stream_program(pkg, model, deferred, texts):
    """The config-4 program; returns (embedded rows by id, query replies,
    engine stats)."""
    pw = JPW if pkg == "jax" else TPW
    from importlib import import_module

    kafka = import_module(f"{pw.__name__}.io.kafka")
    pw.clear_graph()
    broker = kafka.InMemoryKafkaBroker()
    for i, t in enumerate(texts):
        broker.produce("docs", json.dumps({"id": i, "text": t}).encode())
    broker.close()

    class DocSchema(pw.Schema):
        id: int
        text: str

    emb = _embedder(pkg, model, deferred)
    docs = pw.io.kafka.read(broker, topic="docs", schema=DocSchema)
    embedded = docs.select(docs.id, docs.text, vec=emb(docs.text))
    index = pw.indexing.DataIndex(embedded, _knn(pkg, pw, embedded.vec,
                                                reserved_space=len(texts) + 512))
    queries = pw.debug.table_from_rows(pw.schema_from_types(qtext=str),
                                       [(q,) for q in QUERIES])
    q_emb = queries.select(qvec=emb(queries.qtext))
    res = index.query_as_of_now(q_emb.qvec, number_of_matches=K)
    rows, replies, lock = {}, [], threading.Lock()

    def on_doc(key, row, time, is_addition):
        with lock:
            if is_addition:
                rows[key.value] = (canon(row["id"]), row["vec"], row["text"])
            else:
                rows.pop(key.value, None)

    pw.io.subscribe(embedded, on_change=on_doc)
    pw.io.subscribe(res, on_change=lambda key, row, time, is_addition: replies.append(
        (key.value, canon(row["id"]), is_addition)))

    connectors = list(pw.G.connectors)  # this run's, not a later one's

    def stopper():
        deadline = time.time() + 120
        while time.time() < deadline:
            with lock:
                if len(rows) >= len(texts) and len(replies) >= len(QUERIES):
                    break
            time.sleep(0.02)
        for c in connectors:
            c._stop.set()
            c.close()

    threading.Thread(target=stopper, daemon=True).start()
    pw.run()
    stats = import_module(f"{pw.__name__}.internals.run").LAST_RUN_STATS
    return rows, replies, stats


@pytest.mark.parametrize("deferred", [True, False])
def test_config4_stream_equals_jax(models, deferred):
    texts = _texts()
    got = {pkg: _stream_program(pkg, models[pkg], deferred, texts)
           for pkg in ("jax", "torch")}
    t_rows, t_replies, t_stats = got["torch"]
    j_rows, j_replies, _ = got["jax"]
    assert len(t_rows) == N_DOCS
    assert t_rows.keys() == j_rows.keys()
    direct = {pkg: dict(zip(texts, models[pkg].embed_batch(texts))) for pkg in got}
    for k, (doc_id, vec, text) in t_rows.items():
        assert (doc_id, text) == (j_rows[k][0], j_rows[k][2])
        np.testing.assert_array_equal(vec, direct["torch"][text])
        np.testing.assert_array_equal(j_rows[k][1], direct["jax"][text])
        np.testing.assert_allclose(vec, j_rows[k][1], rtol=0, atol=1e-4)
    # both live queries are answered (as of the moment they ran)
    assert sorted(k for k, _ids, add in t_replies if add) == \
        sorted(k for k, _ids, add in j_replies if add)
    assert t_stats.engine_tax()["steps"] > 0 and t_stats.finished


def test_config4_deferred_equals_blocking(models):
    texts = _texts(128, seed=3)
    a, _, _ = _stream_program("torch", models["torch"], True, texts)
    b, _, _ = _stream_program("torch", models["torch"], False, texts)
    assert a.keys() == b.keys() and len(a) == 128
    for k in a:
        assert a[k][0] == b[k][0]
        np.testing.assert_array_equal(a[k][1], b[k][1])


def test_data_index_query_replies_equal_jax(models):
    """Static docs and queries: DataIndex.query over the embedded docs
    gives JAX's replies (row ids of the queries, the matched doc ids in
    rank order)."""
    texts = _texts(256, seed=5)
    q_texts = [texts[3], texts[100], "gamma gamma beta"]
    out = {}
    for pkg, pw in (("jax", JPW), ("torch", TPW)):
        pw.clear_graph()
        emb = _embedder(pkg, models[pkg], deferred=False)
        docs = pw.debug.table_from_rows(pw.schema_from_types(doc=int, text=str),
                                        list(enumerate(texts)))
        embedded = docs.select(docs.doc, vec=emb(docs.text))
        index = pw.indexing.DataIndex(embedded, _knn(pkg, pw, embedded.vec))
        queries = pw.debug.table_from_rows(pw.schema_from_types(q=str),
                                           [(q,) for q in q_texts])
        res = index.query(queries.select(qv=emb(queries.q)).qv, number_of_matches=3)
        rows, cols = final_state(pkg, res)
        out[pkg] = {k: row[cols.index("doc")] for k, row in rows.items()}
    assert out["torch"] == out["jax"]
    assert {ids[0] for ids in out["torch"].values()} >= {3, 100}


_NO_PANDAS = textwrap.dedent('''
    import datetime, importlib.abc, json, sys, threading, time

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("pandas", "xxhash"):
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    for m in [m for m in sys.modules if m.split(".")[0] in ("pandas", "xxhash")]:
        del sys.modules[m]

    import numpy as np
    import torch
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.value import hash_values
    from pathway_tpu_torch.io.kafka import InMemoryKafkaBroker
    from pathway_tpu_torch.models import HashTokenizer, SentenceEmbedderModel, TransformerConfig
    from pathway_tpu_torch.xpacks.llm import SentenceTransformerEmbedder

    cfg = TransformerConfig(vocab_size=1000, hidden=32, layers=2, heads=4,
                            intermediate=64, dtype=torch.float32)
    model = SentenceEmbedderModel(cfg, tokenizer=HashTokenizer(vocab_size=1000, max_length=64),
                                  max_length=64, device="cpu")
    out = {}
    for deferred in (True, False):
        pw.clear_graph()
        broker = InMemoryKafkaBroker()
        rng = np.random.default_rng(11)
        words = ["alpha", "beta", "gamma", "delta", "stream", "tensor", "index"]
        for i in range(64):
            broker.produce("docs", json.dumps({"id": i, "text": " ".join(rng.choice(words, 24))}).encode())
        broker.close()

        class DocSchema(pw.Schema):
            id: int
            text: str

        emb = SentenceTransformerEmbedder(model, max_batch_size=32, deferred=deferred)
        docs = pw.io.kafka.read(broker, topic="docs", schema=DocSchema)
        embedded = docs.select(docs.id, vec=emb(docs.text))
        index = pw.indexing.DataIndex(embedded, pw.indexing.BruteForceKnn(
            embedded.vec, dimensions=32, reserved_space=576, metric="cos", device="cpu"))
        queries = pw.debug.table_from_rows(pw.schema_from_types(qtext=str), [("alpha beta",)])
        res = index.query_as_of_now(queries.select(qv=emb(queries.qtext)).qv, number_of_matches=3)
        seen, replies = set(), []
        pw.io.subscribe(embedded, on_change=lambda key, row, time, is_addition: seen.add(key.value))
        pw.io.subscribe(res, on_change=lambda key, row, time, is_addition: replies.append(1))

        connectors = list(pw.G.connectors)  # this run's, not a later one's

        def stop():
            deadline = time.time() + 60
            while time.time() < deadline and len(seen) < 64:
                time.sleep(0.02)
            for c in connectors:
                c._stop.set(); c.close()

        threading.Thread(target=stop, daemon=True).start()
        pw.run()
        out[str(deferred)] = [len(seen), len(replies)]
    out["datetime_key"] = hash_values(datetime.datetime(2024, 1, 2, 3, 4, 5, 6789))
    out["loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("pandas", "xxhash"))
    print(json.dumps(out))
''')


def test_config4_runs_without_pandas_and_xxhash():
    import datetime

    want_key = hash_values(datetime.datetime(2024, 1, 2, 3, 4, 5, 6789))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    proc = subprocess.run([sys.executable, "-c", _NO_PANDAS], cwd=root, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["True"] == [64, 1] and out["False"] == [64, 1]
    assert out["datetime_key"] == want_key
    assert out["loaded"] == []

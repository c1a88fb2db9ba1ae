"""The API-client UDFs and the vision parsers of the port's LLM xpack
against the JAX package's (``tests/test_xpack_llm.py``'s SlideParser cases
and ``tests/test_misc_parity.py::test_vision_parse_images_roundtrip`` are
the bar).

None of the SDKs may be downloaded, so each client runs twice: with its
SDK missing (the ``ImportError`` must be JAX's), and against a recording
fake SDK module installed in ``sys.modules``, where the port's result and
the calls it made must equal JAX's on the same fake. Exact equality: the
clients compute nothing of their own."""

import asyncio
import hashlib
import importlib.machinery
import sys
import types

import numpy as np
import PIL.Image
import pytest

import pathway_tpu_torch as TPW
from pathway_tpu.xpacks.llm import embedders as jemb
from pathway_tpu.xpacks.llm import llms as jllms
from pathway_tpu.xpacks.llm import parsers as jparsers
from pathway_tpu.xpacks.llm import rerankers as jrr
from pathway_tpu_torch.xpacks.llm import embedders as temb
from pathway_tpu_torch.xpacks.llm import llms as tllms
from pathway_tpu_torch.xpacks.llm import parsers as tparsers
from pathway_tpu_torch.xpacks.llm import rerankers as trr

PKGS = {"jax": (jemb, jllms, jrr, jparsers), "torch": (temb, tllms, trr, tparsers)}


def _module(monkeypatch, name, **attrs):
    mod = types.ModuleType(name)
    mod.__spec__ = importlib.machinery.ModuleSpec(name, None)
    for k, v in attrs.items():
        setattr(mod, k, v)
    monkeypatch.setitem(sys.modules, name, mod)
    return mod


def _call(udf, *args, **kwargs):
    out = udf.__wrapped__(*args, **kwargs)
    if asyncio.iscoroutine(out):
        out = asyncio.run(out)
    return out


def _ns(**kw):
    return types.SimpleNamespace(**kw)


# --------------------------------------------------------------- fake SDKs

def fake_openai(monkeypatch, calls):
    class _Embeddings:
        async def create(self, **kw):
            calls.append(("embeddings.create", kw))
            n = len(kw["input"][0])
            return _ns(data=[_ns(embedding=[float(n), 0.5, -1.25])])

    class _Completions:
        async def create(self, **kw):
            calls.append(("chat.completions.create", kw))
            content = kw["messages"][-1]["content"]
            if isinstance(content, list):  # a vision message: text + image
                url = content[1]["image_url"]["url"]
                digest = hashlib.sha256(url.encode()).hexdigest()[:12]
                text = f"slide {digest}"
            else:
                text = f"echo:{content}:{kw.get('model')}"
            return _ns(choices=[_ns(message=_ns(content=text))])

    class AsyncOpenAI:
        def __init__(self, **kw):
            calls.append(("AsyncOpenAI", kw))
            self.embeddings = _Embeddings()
            self.chat = _ns(completions=_Completions())

    return _module(monkeypatch, "openai", AsyncOpenAI=AsyncOpenAI)


def fake_litellm(monkeypatch, calls):
    async def aembedding(**kw):
        calls.append(("aembedding", kw))
        return _ns(data=[{"embedding": [1.0, float(len(kw["input"][0]))]}])

    def completion(**kw):
        calls.append(("completion", kw))
        return _ns(choices=[{"message": {"content": f"lite:{kw['messages'][-1]['content']}"}}])

    return _module(monkeypatch, "litellm", aembedding=aembedding, completion=completion)


def fake_genai(monkeypatch, calls):
    def embed_content(**kw):
        calls.append(("embed_content", kw))
        return {"embedding": [0.25, float(len(kw["content"]))]}

    genai = _module(monkeypatch, "google.generativeai", embed_content=embed_content)
    import google

    monkeypatch.setattr(google, "generativeai", genai, raising=False)
    return genai


def fake_cohere(monkeypatch, calls):
    class Client:
        def chat(self, **kw):
            calls.append(("chat", kw))
            cit = _ns(start=0, end=2, text="ok", document_ids=["d0"])
            return _ns(text=f"cohere:{kw['message']}", citations=[cit])

    return _module(monkeypatch, "cohere", Client=Client)


def fake_transformers(monkeypatch, calls):
    class _Tok:
        def tokenize(self, s):
            return s.split()

        def convert_tokens_to_string(self, toks):
            return " ".join(toks)

    class _Pipe:
        tokenizer = _Tok()

        def __call__(self, messages, **kw):
            calls.append(("pipeline()", kw))
            if isinstance(messages, list):
                return [{"generated_text": messages + [
                    {"role": "assistant", "content": f"hf:{messages[-1]['content']}"}]}]
            return [{"generated_text": f"hf:{messages}"}]

    def pipeline(task, model=None, device=None, **kw):
        calls.append(("pipeline", task, model, str(device), kw))
        return _Pipe()

    return _module(monkeypatch, "transformers", pipeline=pipeline)


def fake_flashrank(monkeypatch, calls):
    class RerankRequest:
        def __init__(self, query, passages):
            self.query, self.passages = query, passages

    class Ranker:
        def __init__(self, model_name, max_length):
            calls.append(("Ranker", model_name, max_length))

        def rerank(self, req):
            calls.append(("rerank", req.query, req.passages))
            return [{"score": len(req.query) / (1 + len(req.passages[0]["text"]))}]

    return _module(monkeypatch, "flashrank", Ranker=Ranker, RerankRequest=RerankRequest)


# ------------------------------------------------------ missing-SDK errors

MISSING = [
    # (sys.modules entries hidden, build(emb, llms, rr) -> (udf, args) or
    #  raises at construction, expected message)
    (["openai"], lambda e, l, r: (e.OpenAIEmbedder(), ("hi",)), "`openai` package"),
    (["litellm"], lambda e, l, r: (e.LiteLLMEmbedder(model="m"), ("hi",)), "`litellm`"),
    (["google.generativeai"], lambda e, l, r: (e.GeminiEmbedder(), ("hi",)),
     "google-generativeai"),
    (["openai"], lambda e, l, r: (l.OpenAIChat(), ([{"role": "user", "content": "q"}],)),
     "`openai` package"),
    (["litellm"], lambda e, l, r: (l.LiteLLMChat(model="m"),
                                   ([{"role": "user", "content": "q"}],)), "`litellm`"),
    (["cohere"], lambda e, l, r: (l.CohereChat(), ([{"role": "user", "content": "q"}],)),
     "`cohere` package"),
    (["transformers"], lambda e, l, r: (l.HFPipelineChat(model="m", device="cpu"), ()),
     "`transformers` package"),
    (["flashrank"], lambda e, l, r: (r.FlashRankReranker(), ()), "`flashrank` package"),
]


@pytest.mark.parametrize("hidden,build,needle", MISSING,
                         ids=[m[2] + str(i) for i, m in enumerate(MISSING)])
def test_missing_sdk_raises_jax_error(monkeypatch, hidden, build, needle):
    for name in hidden:
        monkeypatch.setitem(sys.modules, name, None)
    msgs = {}
    for pkg, (e, l, r, _p) in PKGS.items():
        with pytest.raises(ImportError) as info:
            udf, args = build(e, l, r)
            _call(udf, *args)
        msgs[pkg] = str(info.value)
    assert msgs["torch"] == msgs["jax"]
    assert needle in msgs["torch"]


# ------------------------------------------------------ clients on fakes

def _both(monkeypatch, fake, run):
    """``run(emb, llms, rr)`` on each package under one fake SDK: the
    results and the SDK calls, per package."""
    out = {}
    for pkg, (e, l, r, _p) in PKGS.items():
        calls: list = []
        fake(monkeypatch, calls)
        result = run(e, l, r)
        out[pkg] = (result, calls)
    return out


def _eq(a, b):
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


CLIENTS = {
    "OpenAIEmbedder": (fake_openai, lambda e, l, r: _call(
        e.OpenAIEmbedder(api_key="k", dimensions=3), "some text")),
    "OpenAIEmbedder-empty": (fake_openai, lambda e, l, r: _call(
        e.OpenAIEmbedder(model=None, base_url="http://x"), "")),
    "LiteLLMEmbedder": (fake_litellm, lambda e, l, r: _call(
        e.LiteLLMEmbedder(model="text-embedding"), "abc")),
    "GeminiEmbedder": (fake_genai, lambda e, l, r: _call(
        e.GeminiEmbedder(task_type="retrieval_document"), "gemini text")),
    "OpenAIChat": (fake_openai, lambda e, l, r: _call(
        l.OpenAIChat(model="gpt-x", temperature=0.0, api_key="k"),
        [{"role": "user", "content": "question?"}], max_tokens=5)),
    "OpenAIChat-json": (fake_openai, lambda e, l, r: _call(
        l.OpenAIChat(), TPW.Json([{"role": "user", "content": "j"}])
        if l is tllms else __import__("pathway_tpu").Json([{"role": "user", "content": "j"}]))),
    "LiteLLMChat": (fake_litellm, lambda e, l, r: _call(
        l.LiteLLMChat(model="ollama/x"), [{"role": "user", "content": "lite q"}])),
    "CohereChat": (fake_cohere, lambda e, l, r: _call(
        l.CohereChat(), [{"role": "system", "content": "s"},
                         {"role": "user", "content": "cq"}],
        documents=[{"text": "d0"}])),
    "HFPipelineChat": (fake_transformers, lambda e, l, r: _call(
        l.HFPipelineChat(model="gpt2", device="cpu", batch_size=2,
                         max_new_tokens=3), [{"role": "user", "content": "hf q"}])),
    "HFPipelineChat-str": (fake_transformers, lambda e, l, r: (
        _call(l.HFPipelineChat(model="gpt2", device="cpu"), "plain prompt"),
        l.HFPipelineChat(model="gpt2", device="cpu").crop_to_max_length(
            "a b c d e", max_prompt_length=2))),
    "FlashRankReranker": (fake_flashrank, lambda e, l, r: _call(
        r.FlashRankReranker(max_length=128), "the doc text", "a query")),
}


@pytest.mark.parametrize("name", sorted(CLIENTS))
def test_client_equals_jax_on_a_fake_sdk(monkeypatch, name):
    fake, run = CLIENTS[name]
    out = _both(monkeypatch, fake, run)
    (jres, jcalls), (tres, tcalls) = out["jax"], out["torch"]
    if name.startswith("CohereChat"):
        # citations come back as dicts of the fake's objects
        assert tres == jres and tres[0] == "cohere:cq" and tres[1][0]["text"] == "ok"
    elif isinstance(jres, tuple):
        assert all(_eq(a, b) for a, b in zip(tres, jres))
    else:
        assert _eq(tres, jres), (tres, jres)
    if name.startswith("HFPipelineChat"):
        # JAX's pipeline gets the string "cpu", the port torch.device("cpu")
        assert str(tcalls) == str(jcalls)
    else:
        assert tcalls == jcalls
    if "Embedder" in name:
        assert isinstance(tres, np.ndarray)


def test_hf_pipeline_chat_defaults_to_the_card(monkeypatch):
    """JAX's default device is "cpu"; the port's None is the card, so on
    a machine without CUDA it raises unless the CPU is asked for."""
    import torch

    calls: list = []
    fake_transformers(monkeypatch, calls)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tllms.HFPipelineChat(model="gpt2")
    chat = tllms.HFPipelineChat(model="gpt2", device="cpu")
    assert chat.device == torch.device("cpu")
    assert calls[-1][3] == "cpu"


# --------------------------------------------------------- vision parsers

def _pages(n, size=(40, 60)):
    return [PIL.Image.fromarray(np.full((*size, 3), i * 40, dtype=np.uint8))
            for i in range(n)]


def test_slide_parser_describes_each_page():
    results = {}
    for pkg, (_e, _l, _r, P) in PKGS.items():
        prompts = []

        def mock_vision_llm(messages, model=None, prompts=prompts):
            content = messages[0]["content"]
            prompts.append(content[0]["text"])
            assert content[1]["image_url"]["url"].startswith("data:image")
            return f"slide description {len(prompts)}"

        parser = P.SlideParser(llm=mock_vision_llm, parse_prompt="What is on this slide?",
                               page_renderer=lambda contents: _pages(3))
        chunks = parser.__wrapped__(b"%PDF-fake-deck")
        assert len(chunks) == 3
        assert sorted(t for t, _ in chunks) == [f"slide description {i}" for i in (1, 2, 3)]
        assert [m["page_number"] for _, m in chunks] == [1, 2, 3]
        assert all(m["page_count"] == 3 for _, m in chunks)
        assert prompts[0] == "What is on this slide?"
        results[pkg] = sorted(chunks)
    assert results["torch"] == results["jax"]


def test_slide_parser_screenshot_metadata():
    out = {}
    for pkg, (_e, _l, _r, P) in PKGS.items():
        page = PIL.Image.fromarray(np.zeros((10, 10, 3), dtype=np.uint8))
        parser = P.SlideParser(llm=lambda messages, model=None: "desc",
                               page_renderer=lambda contents: [page],
                               include_page_screenshot=True)
        ((text, meta),) = parser.__wrapped__(b"deck")
        assert text == "desc" and len(meta["page_screenshot"]) > 20
        out[pkg] = meta
    assert out["torch"] == out["jax"]


def test_slide_parser_without_renderer_requires_pdf2image(monkeypatch):
    monkeypatch.setitem(sys.modules, "pdf2image", None)
    for pkg, (_e, _l, _r, P) in PKGS.items():
        parser = P.SlideParser(llm=lambda m, model=None: "x")
        with pytest.raises(ImportError, match="pdf2image"):
            parser.__wrapped__(b"%PDF")


@pytest.mark.parametrize("run_mode", ["parallel", "sequential"])
def test_parse_images_equals_jax(run_mode):
    from pathway_tpu.xpacks.llm._parser_utils import img_to_b64 as j_b64
    from pathway_tpu.xpacks.llm._parser_utils import maybe_downscale as j_down
    from pathway_tpu_torch.xpacks.llm._parser_utils import img_to_b64, maybe_downscale

    img = PIL.Image.fromarray(np.zeros((300, 400, 3), dtype=np.uint8))
    assert img_to_b64(img) == j_b64(img)
    small = maybe_downscale(img, max_image_size=1000, downsize_horizontal_width=32)
    assert small.size == j_down(img, 1000, 32).size == (32, 24)

    async def fake_llm(messages, model=None):
        url = messages[0]["content"][1]["image_url"]["url"]
        return f"described:{model}:{len(url)}"

    imgs = [img, *_pages(2)]
    got = {pkg: asyncio.run(P.parse_images(imgs, fake_llm, "desc", run_mode=run_mode,
                                           max_image_size=1000,
                                           downsize_horizontal_width=32))
           for pkg, (_e, _l, _r, P) in PKGS.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][0][0].startswith("described:gpt-4o") and got["torch"][1] == []
    with pytest.raises(ValueError):
        asyncio.run(tparsers.parse_images(imgs, fake_llm, "d", run_mode="nope"))
    with pytest.raises(ValueError, match="detail_parse_schema"):
        asyncio.run(tparsers.parse_images(imgs, fake_llm, "d", parse_details=True))


def test_image_parser_equals_jax():
    seen = {}
    for pkg, (_e, _l, _r, P) in PKGS.items():
        def llm(messages, pkg=pkg):
            seen[pkg] = messages
            return "an image of zeros"

        udf_llm = _ns(__wrapped__=llm)
        out = P.ImageParser(udf_llm, parse_prompt="What?").__wrapped__(b"\x89PNG-bytes")
        assert out == [("an image of zeros", {})]
    assert seen["torch"] == seen["jax"]


def test_default_vision_llm_is_lazy():
    assert tparsers._LazyVisionLLM._inner is None
    parser = tparsers.SlideParser(page_renderer=lambda c: [])
    assert parser.llm is tparsers.DEFAULT_VISION_LLM
    assert tparsers._LazyVisionLLM._inner is None
    assert parser.__wrapped__(b"empty deck") == []
    assert tparsers._LazyVisionLLM._inner is None


def test_slide_parser_through_openai_chat(monkeypatch):
    """phase 26 (c)'s CPU twin: decks rendered to PIL pages, each page
    described by ``OpenAIChat`` over a fake ``openai`` whose answer derives
    from the image bytes. JAX's SlideParser fails here (it sets the model
    on the chat's bound ``__wrapped__``; ROADMAP C), so the port's chunks
    are held against a host model of the same fake: one call a page, the
    configured model, the description of that page's PNG."""
    from pathway_tpu_torch.xpacks.llm._parser_utils import img_to_b64

    decks = {f"deck{d}".encode(): _pages(4, size=(24 + d, 32)) for d in range(3)}
    calls: list = []
    fake_openai(monkeypatch, calls)
    parser = tparsers.SlideParser(llm=tllms.OpenAIChat(model="gpt-4o-mini"),
                                  page_renderer=lambda contents: decks[contents])
    chunks = [parser.__wrapped__(k) for k in decks]

    def described(page):
        url = f"data:image/png;base64,{img_to_b64(page)}"
        return f"slide {hashlib.sha256(url.encode()).hexdigest()[:12]}"

    assert chunks == [[(described(p), {"page_number": i + 1, "page_count": 4})
                       for i, p in enumerate(pages)] for pages in decks.values()]
    creates = [kw for name, kw in calls if name == "chat.completions.create"]
    assert len(creates) == 12 and all(kw["model"] == "gpt-4o-mini" for kw in creates)
    jparser = jparsers.SlideParser(llm=jllms.OpenAIChat(model="gpt-4o-mini"),
                                   page_renderer=lambda contents: decks[contents])
    with pytest.raises(AttributeError):
        jparser.__wrapped__(b"deck0")

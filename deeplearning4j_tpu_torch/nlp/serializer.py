"""WordVectorSerializer: Google word2vec text/binary formats + zip model —
counterpart of ``deeplearning4j_tpu/nlp/serializer.py``.

Reference: ``models/embeddings/loader/WordVectorSerializer.java`` (~2k LoC):
``writeWordVectors`` (text: header "V D", then "word f1 f2 ..."),
Google binary format (header line, then ``word<space><D float32 LE>``),
``writeFullModel``/zip round trip of vocab + syn0/syn1 + config.

The formats are the reference package's byte for byte (text and binary
files written from equal vectors are equal; a zip's entries are), so
the port reads what the JAX package writes and the other way round:
the full-model zip is how trained weights cross between the two.  The
readers place the matrices on ``device`` (``cuda`` unless the caller
names the CPU).
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord
from deeplearning4j_tpu_torch.nlp.word2vec import StaticWord2Vec


def _host(t) -> Optional[np.ndarray]:
    return None if t is None else t.detach().cpu().numpy()


def lookup_from_numpy(vocab: VocabCache, syn0, syn1=None, syn1neg=None,
                      device=None) -> InMemoryLookupTable:
    """A lookup table over ``vocab`` holding numpy ``syn0`` (and
    ``syn1``/``syn1neg`` where given) as float32 tensors on ``device``:
    weights carried from another package."""
    syn0 = np.asarray(syn0, np.float32)
    lookup = InMemoryLookupTable(vocab, syn0.shape[1],
                                 negative=0 if syn1neg is None else 1,
                                 use_hs=syn1 is not None, device=device)

    def put(a):
        return (None if a is None else
                torch.as_tensor(np.array(a, np.float32)).to(lookup.device))

    lookup.syn0, lookup.syn1, lookup.syn1neg = put(syn0), put(syn1), put(syn1neg)
    lookup._build_neg_cdf()
    return lookup


# ----------------------------------------------------------------- text fmt

def write_word_vectors(model, path: str) -> None:
    """Google/gensim text format."""
    vocab, lookup = model.vocab, model.lookup
    syn0 = _host(lookup.syn0)
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"{len(vocab)} {lookup.vector_length}\n")
        for el in vocab.vocab_words():
            vec = " ".join(f"{x:.6f}" for x in syn0[el.index])
            f.write(f"{el.label} {vec}\n")


def read_word_vectors(path: str, device=None) -> StaticWord2Vec:
    """Reads the text format into a query-only model (file order = index
    order, as the reference loader preserves it)."""
    cache = VocabCache()
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        header = f.readline().split()
        V, D = int(header[0]), int(header[1])
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) < D + 1:
                continue
            cache.add_token(VocabWord(label=parts[0]))
            rows.append(np.array(parts[1:D + 1], np.float32))
    order = list(cache._by_label.values())
    for i, el in enumerate(order):
        el.index = i
    cache._by_index = order
    cache.total_word_count = float(len(order))
    return StaticWord2Vec(cache, lookup_from_numpy(cache, np.stack(rows),
                                                   device=device))


# --------------------------------------------------------------- binary fmt

def write_binary(model, path: str) -> None:
    """Google word2vec binary format (header text line; per word: label,
    space, D little-endian float32, newline)."""
    vocab, lookup = model.vocab, model.lookup
    syn0 = _host(lookup.syn0).astype(np.float32)
    with open(path, "wb") as f:
        f.write(f"{len(vocab)} {lookup.vector_length}\n".encode())
        for el in vocab.vocab_words():
            f.write(el.label.encode("utf-8") + b" ")
            f.write(syn0[el.index].astype("<f4").tobytes())
            f.write(b"\n")


def read_binary(path: str, device=None) -> StaticWord2Vec:
    with open(path, "rb") as f:
        header = f.readline().decode().split()
        V, D = int(header[0]), int(header[1])
        cache = VocabCache()
        rows = []
        order = []
        for _ in range(V):
            word_bytes = bytearray()
            while True:
                ch = f.read(1)
                if ch == b" " or ch == b"":
                    break
                word_bytes.extend(ch)
            word = word_bytes.decode("utf-8").lstrip("\n")
            vec = np.frombuffer(f.read(4 * D), dtype="<f4").astype(np.float32)
            f.read(1)  # trailing newline
            el = cache.add_token(VocabWord(label=word))
            order.append(el)
            rows.append(vec)
    for i, el in enumerate(order):
        el.index = i
    cache._by_index = order
    cache.total_word_count = float(V)
    return StaticWord2Vec(cache, lookup_from_numpy(cache, np.stack(rows),
                                                   device=device))


# ------------------------------------------------------------------ zip fmt

def write_full_model(model, path: str) -> None:
    """Zip container: vocab.json (labels/freqs/codes) + syn0/syn1/syn1neg
    npy + config.json.  ≙ ``WordVectorSerializer.writeFullModel``."""
    vocab, lookup = model.vocab, model.lookup
    cfg = getattr(model, "config", None)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        vocab_rec = [{
            "label": el.label,
            "frequency": el.element_frequency,
            "index": el.index,
            "codes": el.codes,
            "points": el.points,
            "special": el.special,
        } for el in vocab.vocab_words()]
        zf.writestr("vocab.json", json.dumps(vocab_rec))
        meta = {
            "vector_length": lookup.vector_length,
            "negative": lookup.negative,
            "use_hs": lookup.use_hs,
            "total_word_count": vocab.total_word_count,
        }
        if cfg is not None:
            meta["config"] = {k: getattr(cfg, k) for k in (
                "layer_size", "window", "negative", "use_hierarchic_softmax",
                "min_word_frequency", "epochs", "learning_rate", "seed",
                "elements_algorithm")}
        zf.writestr("config.json", json.dumps(meta))

        def put(name, arr):
            if arr is None:
                return
            buf = io.BytesIO()
            np.save(buf, _host(arr))
            zf.writestr(name, buf.getvalue())

        put("syn0.npy", lookup.syn0)
        put("syn1.npy", lookup.syn1)
        put("syn1neg.npy", lookup.syn1neg)


def read_full_model(path: str, device=None) -> StaticWord2Vec:
    with zipfile.ZipFile(path, "r") as zf:
        vocab_rec = json.loads(zf.read("vocab.json").decode())
        meta = json.loads(zf.read("config.json").decode())
        cache = VocabCache()
        order = []
        for rec in vocab_rec:
            el = VocabWord(label=rec["label"],
                           element_frequency=rec["frequency"],
                           index=rec["index"], special=rec.get("special", False))
            el.codes = rec.get("codes", [])
            el.points = rec.get("points", [])
            cache._by_label[el.label] = el
            order.append(el)
        order.sort(key=lambda e: e.index)
        cache._by_index = order
        cache.total_word_count = meta.get("total_word_count",
                                          float(len(order)))

        def get(name):
            try:
                return np.load(io.BytesIO(zf.read(name)))
            except KeyError:
                return None

        lookup = InMemoryLookupTable(cache, meta["vector_length"],
                                     negative=meta.get("negative", 0),
                                     use_hs=meta.get("use_hs", True),
                                     device=device)
        for name in ("syn0", "syn1", "syn1neg"):
            a = get(name + ".npy")
            setattr(lookup, name,
                    None if a is None else torch.as_tensor(a).to(lookup.device))
        lookup._build_neg_cdf()
    return StaticWord2Vec(cache, lookup)

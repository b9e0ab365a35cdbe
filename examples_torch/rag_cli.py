"""RAG command-line app: ingest documents, retrieve with hybrid search,
answer with an optional LLM — the PyTorch/CUDA port's rendition of the
reference's RAG CLI (examples/rag_example.py:1-18).

    python examples_torch/rag_cli.py ingest path/to/docs/ --db ./rag_db
    python examples_torch/rag_cli.py ask "what is the MXU?" --db ./rag_db
    python examples_torch/rag_cli.py chat --db ./rag_db   # interactive

Runs on the card (``--device cuda``, the default) or ``--device cpu``.  A
``--db`` directory written by the JAX package's ``examples/rag_cli.py``
opens here (the same container and BM25 sidecar) and the other way round.

Capabilities demonstrated end-to-end:
  * chunking with overlap + provenance metadata,
  * a persistent HybridCollection (vector + BM25 in one store, saved to
    disk and reloaded across invocations),
  * hybrid retrieval with alpha-fusion and metadata filters,
  * prompt assembly with inline [n] citations,
  * optional answer generation via the `anthropic` package when installed
    AND ANTHROPIC_API_KEY and RAG_MODEL (the model id) are set; otherwise
    an extractive offline answer
    so the example always runs.

Everything runs offline by default (HashingEmbedder).
"""

import argparse
import os
import sys
import textwrap
from pathlib import Path

import numpy as np

from fastpyvectordb_tpu_torch.core.types import CollectionConfig
from fastpyvectordb_tpu_torch.embeddings import get_embedder
from fastpyvectordb_tpu_torch.hybrid import HybridCollection

SAMPLE_DOCS = {
    "jax.md": (
        "JAX overview\n\nJAX is a library for array-oriented numerical "
        "computing. It provides composable transformations: grad for "
        "automatic differentiation, jit for XLA compilation, vmap for "
        "auto-vectorization, and shard_map for SPMD programming over a "
        "device mesh. Under jit, Python control flow is traced once; "
        "data-dependent branching needs lax.cond or lax.while_loop."),
    "tpu.md": (
        "TPU architecture\n\nA TPU chip couples a 128x128 systolic-array "
        "matrix unit (the MXU) with a vector unit and high-bandwidth "
        "memory. Peak throughput comes from large, aligned bfloat16 "
        "matrix multiplies; HBM bandwidth is the usual bottleneck, so "
        "compilers fuse elementwise work into the matmuls. Chips are "
        "linked by ICI into pods and programmed with collectives."),
    "vectordb.md": (
        "Vector search\n\nA vector database stores embeddings and serves "
        "nearest-neighbor queries. Exact search is a distance matmul plus "
        "a top-k reduction. Approximate indexes (IVF cells or neighbor "
        "graphs) trade a little recall for speed. Binary and int8 "
        "quantization shrink memory and can feed specialized hardware."),
}


# ---------------------------------------------------------------------------
def chunk_text(text: str, size: int = 400, overlap: int = 80):
    """Greedy word-boundary chunker with character overlap."""
    words = text.split()
    chunks, cur, cur_len = [], [], 0
    carried = None  # the overlap tail carried past the last flush
    for w in words:
        cur.append(w)
        cur_len += len(w) + 1
        if cur_len >= size:
            chunks.append(" ".join(cur))
            # keep a tail of ~overlap chars as context for the next chunk
            tail, tl = [], 0
            for x in reversed(cur):
                tail.append(x)
                tl += len(x) + 1
                if tl >= overlap:
                    break
            cur = list(reversed(tail))
            cur_len = tl
            carried = list(cur)
    if cur and cur != carried:
        # the final buffer can be exactly the overlap tail of the last
        # flushed chunk — a pure duplicate, not new content
        chunks.append(" ".join(cur))
    return chunks


class RagStore:
    """A persistent hybrid (vector+BM25) chunk store with an embedder.

    Persistence rides the collection's own FPVT container: constructing
    with ``base_path`` reloads any prior state; ``save()`` writes both the
    vector store and the BM25 sidecar."""

    def __init__(self, db_dir: str, provider: str = "hashing",
                 device="cuda"):
        self.dir = Path(db_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.embedder = get_embedder(provider, device=device)
        self.col = HybridCollection(
            CollectionConfig(name="rag", dimensions=self.embedder.dimensions,
                             metric="cosine"),
            base_path=self.dir, text_fields=["text"], device=device)

    def save(self):
        self.col.save()

    # -- ingest ------------------------------------------------------------
    def ingest(self, files: dict):
        """files: {name: text}.  Chunks, embeds, indexes with provenance."""
        ids, vecs, metas = [], [], []
        for name, text in files.items():
            for i, ch in enumerate(chunk_text(text)):
                ids.append(f"{name}#{i}")
                vecs.append(self.embedder.embed(ch))
                metas.append({"text": ch, "source": name, "chunk": i})
        # re-ingesting a file replaces ALL its chunks — including stale
        # higher-index chunks when the file shrank (they would otherwise
        # keep serving outdated text)
        existing = set(self.col.all_ids())
        names = {f"{name}#" for name in files}
        stale = [i for i in existing
                 if any(i.startswith(p) for p in names)]
        if stale:
            self.col.delete_batch(stale)
        self.col.insert_batch(np.stack(vecs), ids, metas)
        return len(ids)

    # -- retrieve ----------------------------------------------------------
    def retrieve(self, question: str, k: int = 4, alpha: float = 0.65):
        qv = self.embedder.embed(question)
        return self.col.hybrid_search(qv, question, k=k, alpha=alpha)


# ---------------------------------------------------------------------------
def build_prompt(question: str, hits) -> str:
    ctx = "\n".join(f"[{i + 1}] ({h.id}) {h.metadata['text']}"
                    for i, h in enumerate(hits))
    return textwrap.dedent(f"""\
        Answer the question using ONLY the numbered context passages.
        Cite passages inline as [n].

        Context:
        {ctx}

        Question: {question}
        Answer:""")


def generate(prompt: str) -> str:
    """LLM call if available; extractive fallback otherwise."""
    note = ""
    if os.environ.get("ANTHROPIC_API_KEY") and os.environ.get("RAG_MODEL"):
        try:
            import anthropic
            client = anthropic.Anthropic()
            msg = client.messages.create(
                model=os.environ["RAG_MODEL"],
                max_tokens=400,
                messages=[{"role": "user", "content": prompt}])
            return msg.content[0].text
        except Exception as e:  # offline / quota / bad key
            note = f"(LLM unavailable: {e}) "
    # extractive fallback: surface the top passage as the "answer"
    first = prompt.split("[1] ", 1)
    body = first[1].split("\n", 1)[0] if len(first) > 1 else ""
    return f"{note}(offline extractive answer) {body[:300]} [1]"


def answer(store: RagStore, question: str, k: int = 4,
           alpha: float = 0.65, show_ctx: bool = True):
    hits = store.retrieve(question, k=k, alpha=alpha)
    if not hits:
        print("no indexed documents — run `ingest` first")
        return
    if show_ctx:
        print("\nretrieved:")
        for i, h in enumerate(hits):
            print(f"  [{i + 1}] {h.id:18s} fused={h.score:.3f} "
                  f"(vec={h.vector_score:.3f} kw={h.keyword_score:.3f})")
    print("\n" + generate(build_prompt(question, hits)) + "\n")


# ---------------------------------------------------------------------------
def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cmd", choices=["ingest", "ask", "chat", "sample"])
    ap.add_argument("target", nargs="?", help="docs dir (ingest) / question (ask)")
    ap.add_argument("--db", default="./rag_db")
    ap.add_argument("--provider", default="hashing")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--alpha", type=float, default=0.65,
                    help="vector weight in hybrid fusion")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)

    store = RagStore(a.db, a.provider, device=device or a.device)

    if a.cmd == "sample":
        n = store.ingest(SAMPLE_DOCS)
        store.save()
        print(f"ingested {n} chunks from {len(SAMPLE_DOCS)} sample docs "
              f"-> {a.db}")
    elif a.cmd == "ingest":
        if not a.target:
            ap.error("ingest needs a directory of .txt/.md files")
        files = {}
        root = Path(a.target)
        for p in sorted(root.rglob("*")):
            if p.suffix.lower() in (".txt", ".md") and p.is_file():
                # key by RELATIVE path: same-named files in different
                # subdirectories must not overwrite each other
                files[str(p.relative_to(root))] = \
                    p.read_text(errors="replace")
        if not files:
            sys.exit(f"no .txt/.md files under {a.target}")
        n = store.ingest(files)
        store.save()
        print(f"ingested {n} chunks from {len(files)} files -> {a.db}")
    elif a.cmd == "ask":
        if store.col.count() == 0:
            sys.exit("empty index — run `sample` or `ingest` first")
        if not a.target:
            ap.error("ask needs a question")
        answer(store, a.target, k=a.k, alpha=a.alpha)
    else:  # chat
        if store.col.count() == 0:
            store.ingest(SAMPLE_DOCS)
            print("(empty index: loaded built-in sample docs)")
        print(f"{store.col.count()} chunks indexed. Empty line quits.")
        while True:
            try:
                q = input("rag> ").strip()
            except (EOFError, KeyboardInterrupt):
                break
            if not q:
                break
            answer(store, q, k=a.k, alpha=a.alpha)


if __name__ == "__main__":
    main()

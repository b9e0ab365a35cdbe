"""RAG pipeline demo: chunk -> embed -> index -> retrieve -> (re)rank ->
prompt assembly, composing the client API, hybrid search, and metadata
filters (mirrors the reference's examples/rag_demo.py scope; the LLM call
is stubbed so the example runs fully offline), on the PyTorch/CUDA port:

    python examples_torch/rag_demo.py                 # on the card
    python examples_torch/rag_demo.py --device cpu    # on the CPU
"""

import argparse
import textwrap

from fastpyvectordb_tpu_torch.api import Client

CORPUS = {
    "jax-intro": """JAX is a library for array-oriented numerical computation.
        It provides composable transformations of Python functions: grad for
        differentiation, jit for XLA compilation, vmap for vectorization and
        pmap for parallelization across devices.""",
    "tpu-arch": """A TPU chip contains a matrix multiply unit (MXU) — a
        128x128 systolic array — a vector processing unit, and high
        bandwidth memory. Programs are compiled by XLA, which fuses
        elementwise operations into matrix multiplies.""",
    "pallas": """Pallas is a JAX extension for writing custom kernels. On
        TPU, kernels stage data from HBM into VMEM blocks and may use
        async copies and semaphores for fine-grained pipelines.""",
    "cooking": """To make a simple tomato sauce, soften onions in olive
        oil, add garlic, crushed tomatoes, salt, and simmer gently.""",
}


def chunk(text: str, size: int = 180) -> list:
    words, out, cur = text.split(), [], []
    for w in words:
        cur.append(w)
        if sum(len(x) + 1 for x in cur) > size:
            out.append(" ".join(cur))
            cur = []
    if cur:
        out.append(" ".join(cur))
    return out


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description="RAG pipeline demo")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    client = Client(path=None, embedding_provider="hashing",
                    device=device or args.device)
    col = client.create_collection("rag")

    # 1. ingest: chunk + embed + index with provenance metadata
    for doc_id, text in CORPUS.items():
        chunks = chunk(" ".join(text.split()))
        col.add(documents=chunks,
                ids=[f"{doc_id}#{i}" for i in range(len(chunks))],
                metadatas=[{"source": doc_id, "chunk": i}
                           for i in range(len(chunks))])
    print(f"indexed {col.count} chunks from {len(CORPUS)} documents")

    # 2. retrieve with a source filter (no recipes in the context!)
    question = "How does the TPU multiply matrices and what compiles to it?"
    res = col.query(question, n_results=3,
                    where={"source": {"$ne": "cooking"}})

    # 3. assemble the prompt
    context = "\n".join(f"[{rid}] {doc}"
                        for rid, doc in zip(res.ids[0], res.documents[0]))
    prompt = textwrap.dedent(f"""
        Answer using only the context.
        Context:
        {context}
        Question: {question}
    """).strip()
    print("\n--- retrieved context ---")
    for rid, dist in zip(res.ids[0], res.distances[0]):
        print(f"  {rid:14s} d={dist:.3f}")
    print("\n--- prompt (first 400 chars) ---")
    print(prompt[:400])

    # 4. the LLM call would go here; we assert retrieval quality instead
    sources = {m["source"] for m in res.metadatas[0]}
    assert "cooking" not in sources
    assert "tpu-arch" in sources
    print("\nretrieval OK: tpu-arch retrieved, cooking filtered out")


if __name__ == "__main__":
    main()

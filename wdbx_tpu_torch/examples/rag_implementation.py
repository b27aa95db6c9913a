"""RAG pipeline — embed → search → assemble context → generate.

The port's counterpart of ``examples/rag_implementation.py``: pick an
embedding plugin by the fallback chain, embed the query, search with a
similarity threshold, assemble context from result metadata, and feed
an LLM plugin. Runs offline via the plugins' demo modes
(``WDBX_OLLAMA_DEMO=true``, the default here).

    python -m wdbx_tpu_torch.examples.rag_implementation [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import os

from wdbx_tpu_torch import WDBX
from wdbx_tpu_torch.utils.data_utils import chunk_text

DOCUMENTS = {
    "gpu-intro": (
        "GPUs are throughput processors built around streaming "
        "multiprocessors. Tensor cores multiply tiles; HBM feeds them "
        "through shared memory."
    ),
    "vector-db": (
        "A vector database stores embeddings and retrieves nearest "
        "neighbors by cosine similarity for retrieval-augmented generation."
    ),
    "sharding": (
        "Sharding a corpus across devices lets each one scan its slice "
        "in parallel; the partial top-k lists merge into one answer."
    ),
}


async def rag_pipeline(db: WDBX, question: str) -> str:
    # 1. Resolve an embedding plugin (ollama → lmstudio fallback chain).
    embedder = None
    for name in ("ollama", "lmstudio", "openai"):
        embedder = db.get_plugin(name)
        if embedder is not None:
            break
    if embedder is None:
        raise RuntimeError("no embedding plugin available")

    # 2. Embed the question and retrieve context (demo embeddings are
    #    random, so the threshold is 0.0 here).
    query_embedding = await embedder.create_embedding(question)
    hits = await db.vector_search_async(query_embedding, limit=3, threshold=0.0)

    # 3. Assemble context from result metadata.
    context = "\n\n".join(
        f"[{vid}] {meta.get('content', '')}" for vid, _score, meta in hits
    )

    # 4. Generate with the LLM plugin (chat if available).
    llm = db.get_plugin("ollama") or db.get_plugin("lmstudio")
    prompt = (
        f"Answer using only this context:\n{context}\n\nQuestion: {question}"
    )
    if hasattr(llm, "chat"):
        return await llm.chat([{"role": "user", "content": prompt}])
    return await llm.generate_text(prompt)


async def run(device: str | None, data_dir: str) -> None:
    db = WDBX(vector_dimension=384, data_dir=data_dir, device=device)
    await db.initialize()

    # Ingest: chunk each document, embed, store with content metadata.
    embedder = db.get_plugin("ollama")
    for doc_id, text in DOCUMENTS.items():
        for i, chunk in enumerate(chunk_text(text, chunk_size=200, overlap=40)):
            emb = await embedder.create_embedding(chunk)
            await db.vector_store_async(
                emb, {"content": chunk, "doc": doc_id}, id=f"{doc_id}-{i}"
            )
    print(f"ingested {db.count_vectors()} chunks")

    answer = await rag_pipeline(db, "How do GPUs multiply matrices?")
    print(f"answer: {answer}")
    await db.shutdown()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--data-dir", default="./wdbx_data_rag")
    args = ap.parse_args(argv)
    os.environ.setdefault("WDBX_OLLAMA_DEMO", "true")
    asyncio.run(run(args.device, args.data_dir))


if __name__ == "__main__":
    main()

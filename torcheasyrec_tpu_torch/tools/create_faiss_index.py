"""Build an ANN index over exported item-tower embeddings.

Counterpart of torcheasyrec_tpu/tools/create_faiss_index.py: with faiss
importable, an IVFFlat (inner product) or HNSWFlat index with the item
ids (``faiss_index``, ``id_mapping``); without it, a brute-force index,
``bruteforce_index.npz`` holding ``ids`` (int64) and ``embeddings``
(float32, as read). Neither this package's ``tools/hitrate.py`` nor the
JAX package's reads that file: both read parquet embeddings.

    python -m torcheasyrec_tpu_torch.tools.create_faiss_index \\
        --embedding_input_path items.parquet --index_output_dir index/ \\
        [--index_type IVFFlat|HNSWFlat] [--ivf_nlist 1000] [--hnsw_m 32] \\
        [--id_field id] [--embedding_field embedding]
"""

import argparse
import os

import numpy as np
import pyarrow.parquet as pq


def build_index(
    embedding_path: str,
    index_output_dir: str,
    index_type: str = "IVFFlat",
    ivf_nlist: int = 1000,
    hnsw_m: int = 32,
    id_column: str = "id",
    embedding_column: str = "embedding",
) -> str:
    """The index's path: ``faiss_index`` or ``bruteforce_index.npz``."""
    t = pq.read_table(embedding_path)
    ids = t.column(id_column).to_numpy(zero_copy_only=False).astype(np.int64)
    emb = np.stack(
        t.column(embedding_column).to_numpy(zero_copy_only=False)
    ).astype(np.float32)
    os.makedirs(index_output_dir, exist_ok=True)
    try:
        import faiss
    except ImportError:
        path = os.path.join(index_output_dir, "bruteforce_index.npz")
        np.savez(path, ids=ids, embeddings=emb)
        return path
    d = emb.shape[1]
    if index_type == "HNSWFlat":
        index = faiss.IndexHNSWFlat(d, hnsw_m)
    else:
        quantizer = faiss.IndexFlatIP(d)
        index = faiss.IndexIVFFlat(
            quantizer, d, min(ivf_nlist, max(len(ids) // 39, 1)))
        index.train(emb)
    index = faiss.IndexIDMap2(index)
    index.add_with_ids(emb, ids)
    path = os.path.join(index_output_dir, "faiss_index")
    faiss.write_index(index, path)
    with open(os.path.join(index_output_dir, "id_mapping"), "w") as f:
        for i in ids:
            f.write(f"{i}\n")
    return path


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--embedding_input_path", required=True)
    parser.add_argument("--index_output_dir", required=True)
    parser.add_argument("--index_type", default="IVFFlat")
    parser.add_argument("--ivf_nlist", type=int, default=1000)
    parser.add_argument("--hnsw_m", type=int, default=32)
    parser.add_argument("--id_field", default="id")
    parser.add_argument("--embedding_field", default="embedding")
    args = parser.parse_args()
    out = build_index(
        args.embedding_input_path, args.index_output_dir, args.index_type,
        args.ivf_nlist, args.hnsw_m, args.id_field, args.embedding_field)
    print(f"index written to {out}")

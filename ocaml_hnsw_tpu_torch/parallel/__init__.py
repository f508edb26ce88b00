from ocaml_hnsw_tpu_torch.parallel.sharded import ShardedIndex, sharded_knn, sharded_insert_round

__all__ = ["ShardedIndex", "sharded_knn", "sharded_insert_round"]

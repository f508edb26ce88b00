from ocaml_hnsw_tpu_torch.utils.padding import round_up, pad_to

__all__ = ["round_up", "pad_to"]

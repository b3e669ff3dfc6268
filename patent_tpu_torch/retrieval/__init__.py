"""retrieval of patent_tpu_torch."""

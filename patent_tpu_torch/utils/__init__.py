"""utils of patent_tpu_torch."""

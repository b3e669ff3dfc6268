"""models of patent_tpu_torch."""

"""cli of patent_tpu_torch."""

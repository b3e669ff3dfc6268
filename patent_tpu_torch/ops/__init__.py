"""ops of patent_tpu_torch."""

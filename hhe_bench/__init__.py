"""The benchmark of hhe_tpu_torch: the CSP's request path on one card.
See README.md."""

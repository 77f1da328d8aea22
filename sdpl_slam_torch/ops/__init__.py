"""Device-side math vocabulary: Lie groups, projective/line geometry, kernels."""

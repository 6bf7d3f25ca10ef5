"""One xDeepFM CIN layer, fused with its outer product (``csrc/cin_interaction.cu``)."""

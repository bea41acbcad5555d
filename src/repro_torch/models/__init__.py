"""PyTorch model code for the uniform GQA decoder (dense family)."""

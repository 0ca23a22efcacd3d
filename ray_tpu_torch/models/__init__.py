"""Model families, as plain functions over dicts of tensors."""

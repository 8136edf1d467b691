"""Small helpers shared by the product pipeline."""

"""Step functions (the eval step only so far)."""

"""Weight transfer and seeded random weights."""

"""Device choice and seeded random streams."""

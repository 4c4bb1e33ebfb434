"""Test suite (a package, so `tests.<module>` imports resolve here even
where another installed distribution ships a top-level `tests`)."""

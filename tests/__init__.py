"""Test suite. A regular package, so that `tests.*` imports resolve here even
where an installed package named `tests` is on the path."""

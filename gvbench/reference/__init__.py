"""Plain references, one per driver, and the comparisons that decide correct."""

"""Lane-level building blocks and static transfer tables."""

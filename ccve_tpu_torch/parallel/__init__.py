"""The distributed tier: hash partitioning of keys over P parts."""

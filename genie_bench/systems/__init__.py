"""The drivers of the program under test, one per deployment."""

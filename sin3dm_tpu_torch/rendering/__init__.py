"""The software multi-view renderer."""

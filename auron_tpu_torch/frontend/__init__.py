"""The session entry and a converted query's data holders."""

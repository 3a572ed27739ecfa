"""Storage helpers: the controller's key trie."""

"""Data models: wire types, the sqlite3 store, the tokenizer, the Qwen3 trunk."""

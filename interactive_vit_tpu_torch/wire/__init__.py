"""Wire protocol and graph JSON schema."""

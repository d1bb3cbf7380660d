"""Metadata service: inodes/dirents on the transactional KV
(reference: src/meta/ — SURVEY.md §2.5).

The port of t3fs/meta (host code; no device work): the same serde structs,
KV keys and transactions, so both packages hold the same bytes."""

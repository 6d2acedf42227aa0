"""The sharded multi-card pipeline: process groups (`distributed`) and the
pipeline over them (`stream`)."""

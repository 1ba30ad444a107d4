"""Teacher serving for distillation: the teacher server, its client and its store key."""

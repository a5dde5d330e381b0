"""One module a traffic driver kind, named by a traffic file's ``driver``."""

"""Authentication: the cephx ticket protocol (SURVEY.md §2.4 src/auth/)."""
from .cephx import (AuthError, Authorizer, CephxClient, CephxServiceHandler,
                    KeyServer, Ticket)

__all__ = ["AuthError", "Authorizer", "CephxClient", "CephxServiceHandler",
           "KeyServer", "Ticket"]

"""Operators the collective hook's dispatch mode saw a step
(``hooks/interceptor``'s ``dispatched``, over the steps run with the
hook; nothing where the cell runs no hook)."""


def read(ctx):
    cell = ctx["cell"]
    if getattr(cell, "handlers", None) is None or not cell.steps:
        return None
    return cell.dispatched / cell.steps

"""Address-space layout of the simulated AArch64 process.

Mirrors the paper's map: VA 0 .. 4095 stays unmapped (NULL-page semantics are
preserved — §3.4), the first-level trampoline pool starts at 4096 and the
``movz x8, #imm16`` reach caps it at 65536, giving (65536-4096)/16 = 3840
slots (§3.1/3.2).
"""

WORD = 4

# -- code space --------------------------------------------------------------
NULL_END = 0x1000            # [0, 0x1000): unmapped; jumps here fault (SIGSEGV)
L1_BASE = 0x1000             # first-level trampoline pool (the paper's 4096)
L1_SLOT_BYTES = 16           # movz/movk/movk x8 + br x8
L1_SLOTS = 3840              # the paper's slot budget
L1_END = L1_BASE + L1_SLOT_BYTES * L1_SLOTS
assert L1_END == 0x10000     # == 65536, the movz #imm16 reach

TEXT_BASE = 0x10000          # application .text
CODE_LIMIT = 0x40000         # everything executable lives below this
CODE_WORDS = CODE_LIMIT // WORD

# -- data space --------------------------------------------------------------
DATA_BASE = 0x40000
MAILBOX = 0x40000            # hook -> trampoline virtualised return value
COUNTER = 0x40008            # hook invocation counter (the hook's only effect)
SCRATCH = 0x40010
HEAP_BASE = 0x48000          # I/O buffers for read/write workloads
SIGFRAME = 0x70000           # one in-flight signal at a time
SIGSTACK_TOP = 0x78000       # alt stack for signal handlers
STACK_TOP = 0x80000
MEM_LIMIT = 0x80000
MEM_WORDS = (MEM_LIMIT - DATA_BASE) // 8

# -- Linux arm64 syscall numbers (faithful) ----------------------------------
SYS_DUP = 23
SYS_IOCTL = 29
SYS_OPENAT = 56
SYS_CLOSE = 57
SYS_PIPE2 = 59
SYS_LSEEK = 62
SYS_READ = 63
SYS_WRITE = 64
SYS_FSTAT = 80
SYS_EXIT = 93
SYS_RT_SIGRETURN = 139
SYS_GETPID = 172
SYS_GETRANDOM = 278
MAX_SYSCALL_NR = 600         # the paper's "< 600" discrimination bound

# -- guest-kernel emulation sizing (repro.emul) ------------------------------
# Per-lane fd table and in-memory filesystem: MAX_FDS open-file slots (and
# as many open-file descriptions), MAX_INODES fixed-size inodes of
# FILE_WORDS data words each (4 KiB files), and a PROC_WORDS synthetic
# /proc window rendered from live lane counters.
MAX_FDS = 16
MAX_INODES = 8
FILE_WORDS = 512
FILE_BYTES = FILE_WORDS * 8
PROC_WORDS = 32

# open(2) flag bits consumed by the emulated openat (Linux arm64 values)
O_CREAT = 0o100
O_EXCL = 0o200
O_TRUNC = 0o1000
O_APPEND = 0o2000

# lseek(2) whence
SEEK_SET = 0
SEEK_CUR = 1
SEEK_END = 2

# -- signal numbers ----------------------------------------------------------
SIGILL = 4
SIGTRAP = 5
SIGBUS = 7
SIGSEGV = 11

PID = 4242                   # simulated pid
VIRT_PID = 7777              # the hook's "virtual value" (paper's Table 3 setup)

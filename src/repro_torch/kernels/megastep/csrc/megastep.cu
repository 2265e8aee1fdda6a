// Megastep: `chunk` fetch/decode/execute steps of every fleet lane in one
// launch — the Hopper counterpart of the TPU kernel
// src/repro/kernels/megastep/kernel.py::megastep_chunk (Pallas), all three
// of its variants in one kernel:
//   K1  the untraced executor (ALU, flags, memory, branches, signals, the
//       syscall rows with the guest-kernel emulation off);
//   K3  the guest-kernel emulation service (fd tables, in-memory files,
//       pipes, /proc, getrandom, ioctl) and its data mover, on the lanes
//       whose k_enabled is set;
//   K2  with a trace carry (trace_cap > 0): the seccomp-style policy gate,
//       the record ring, the histogram and the verdict counters.
//
// What it computes: exactly `chunk` iterations of the fleet step
// (repro_torch.core.fleet._step_core).  The result is bit-identical to the
// plain PyTorch version in ../ref.py.
//
// Design: one thread per lane.  At entry a thread loads its lane's
// registers and scalar leaves into registers / local memory, runs the
// chunk as a plain C loop, and writes every leaf back once at the end (the
// merged writeback of the TPU kernel).  The 13 op-spec columns and the
// syscall rows go to shared memory at block start; decode tables are read
// through ids[lane].  The lane's 256 KiB memory stays in device memory:
// it cannot fit on chip (one SM has 227 KB of shared memory).  The rare
// paths — read fill / write sum over the lane's own io_k <= 4096 words,
// the 34-word sigframe push, the emulation service (emul_service), the
// policy gate (policy_gate) and the trace append (trace_append) — run in
// the thread.  The last three are __noinline__ functions that work on the
// lane's own k_* and trace rows in device memory, entered only on svc
// steps, so the common ALU path keeps its registers (with the trace path
// inlined, ptxas spilled 104 bytes and the census ran ~25 % slower).
//
// Data mover arithmetic: as in the JAX package, source indices are clipped
// into the WHOLE flat plane (mem, k_ino_data) and destination indices past
// its end are dropped.  While file offsets stay in [0, FILE_BYTES + 64]
// and inode sizes in [0, FILE_BYTES], the validity checks keep every move
// inside the lane's own rows, which is what makes one unsynchronised thread
// per lane exact.  A guest can leave that domain: lseek(SEEK_SET) takes any
// offset >= 0, and from an offset near INT64_MAX a write's end wraps
// negative, passes the EFBIG check and moves words into the next lane's
// k_ino_data row.  The reference does the same in lockstep; here it races
// with that lane's thread, so such states are outside the kernel's exact
// domain (tests/test_torch_emul.py shows the escape in both packages).
// /proc words are rendered from the lane's own pre-step counters.
//
// What bounds it on this card: a serial chain of dependent steps (the
// census's longest lane runs ~8.3k steps), each a few dependent device
// memory accesses (instruction fetch, then the data word).  The bytes and
// operations are tiny next to the card's rates; the chain's latency is the
// limit.  The design does nothing about that yet: 500 lanes fill ~16
// warps.  Spreading lanes over more SMs and warps is later work.
//
// Integer semantics: JAX int64 arithmetic wraps; C++ signed overflow is
// undefined, so every add / sub / mul / left shift that can overflow goes
// through uint64_t (wadd, wsub, wmul, wshl).  Right shifts of signed values
// are arithmetic, as in JAX (nvcc emits shr.s64).  JAX's // and % floor;
// CUDA's / and % truncate (floor_div, floor_mod).
#include <cstdint>
#include <cuda_runtime.h>

#include "megastep_consts.h"

struct MegastepArgs {
    const int64_t* packed;     // [G, CODE_WORDS] op:6 rd:5 rn:5 rm:5 sh:6 cond:4 sf:1
    const int64_t* imm;        // [G, CODE_WORDS]
    const int32_t* ids;        // [B] image row per lane
    // the 13 op-spec columns ([N_OPS], COND_MASK [16]); bool columns are
    // one byte per entry
    const int32_t* alu;
    const uint8_t* wb_sp;
    const uint8_t* wb_lr;
    const int32_t* flags;
    const int32_t* memc;
    const uint8_t* addr_post;
    const uint8_t* wb_base;
    const int32_t* pcc;
    const uint8_t* segv;
    const uint8_t* exit_;
    const int64_t* signo;
    const int64_t* cost;
    const int64_t* cond_mask;
    // the syscall rows ([N_SYSCALLS])
    const int64_t* sys_nr;
    const int64_t* sys_kind;
    const int64_t* sys_const;
    const int64_t* sys_emul;
    // the MachineState leaves, in field order, each [B, ...] int64
    int64_t* leaf[N_LEAVES];
    // the TraceState leaves, in field order (pol_action is int32); unused
    // when trace_cap == 0
    int64_t* tleaf[N_TRACE_LEAVES];
    int64_t n_lanes;
    int64_t chunk;
    int64_t trace_cap;         // CAP of the trace ring; 0 = untraced
};

__device__ __forceinline__ int64_t wadd(int64_t a, int64_t b) {
    return (int64_t)((uint64_t)a + (uint64_t)b);
}
__device__ __forceinline__ int64_t wsub(int64_t a, int64_t b) {
    return (int64_t)((uint64_t)a - (uint64_t)b);
}
__device__ __forceinline__ int64_t wmul(int64_t a, int64_t b) {
    return (int64_t)((uint64_t)a * (uint64_t)b);
}
__device__ __forceinline__ int64_t wshl(int64_t a, int64_t s) {  // 0 <= s < 64
    return (int64_t)((uint64_t)a << s);
}
__device__ __forceinline__ int64_t clampi(int64_t x, int64_t lo, int64_t hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ bool mem_ok(int64_t addr) {
    return addr >= DATA_BASE && addr < MEM_LIMIT && (addr & 7) == 0;
}
// Word index of an address, clipped into the lane (fleet.py:189): the
// subtraction wraps and the shift is arithmetic, so an address below
// DATA_BASE clips to word 0.
__device__ __forceinline__ int64_t widx(int64_t addr) {
    return clampi(wsub(addr, DATA_BASE) >> 3, 0, MEM_WORDS - 1);
}
// JAX's // floors; CUDA's / truncates toward zero (io_n may be negative).
__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
    int64_t q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
    return q;
}
// JAX's % takes the divisor's sign (b > 0 here); C's takes the dividend's.
__device__ __forceinline__ int64_t floor_mod(int64_t a, int64_t b) {
    int64_t r = a % b;
    return r < 0 ? r + b : r;
}
__device__ __forceinline__ uint64_t splitmix64(uint64_t z) {
    z *= 0x9E3779B97F4A7C15ull;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
}

// The emulated family a lane's svc selects (at most one per step).
enum EmulFam { EF_NONE, EF_OPEN, EF_CLOSE, EF_LSEEK, EF_DUP, EF_FSTAT,
               EF_PIPE, EF_RAND, EF_IOCTL };

// The lane's pre-step counters (the ioctl values and the /proc window).
struct LaneView {
    int64_t icount, cycles, hook_count, enosys_count, emul_served, in_off,
        out_count, out_sum, fuel, pid, virt_getpid;
};

struct SvcOut {
    int64_t ret;
    bool is_ret, served, rd_stream, wr_stream;
};

// One guest-kernel service step for one lane (repro_torch.emul.engine
// service + run_data_loop, specialised to the one syscall this lane
// executes): fd resolution, errno surface, table updates in the lane's
// k_* rows, the fstat / pipe2 result words and the bulk data move.
// `fam` is the emulated family (EF_NONE for a read or write); the caller
// enters only when a family is set or an enabled lane reads or writes.
__device__ __noinline__ SvcOut emul_service(
        const MegastepArgs& a, const int64_t lane, const int fam,
        const bool sys_read, const bool sys_write, const bool en,
        const int64_t x0, const int64_t x1, const int64_t x2,
        const int64_t path_w, const bool io_ok, const int64_t io_n,
        const LaneView v) {
    int64_t* fd_ofd = a.leaf[LEAF_k_fd_ofd] + lane * MAX_FDS;
    int64_t* ofd_kind = a.leaf[LEAF_k_ofd_kind] + lane * MAX_FDS;
    int64_t* ofd_ino = a.leaf[LEAF_k_ofd_ino] + lane * MAX_FDS;
    int64_t* ofd_off = a.leaf[LEAF_k_ofd_off] + lane * MAX_FDS;
    int64_t* ofd_flags = a.leaf[LEAF_k_ofd_flags] + lane * MAX_FDS;
    int64_t* ofd_ref = a.leaf[LEAF_k_ofd_ref] + lane * MAX_FDS;
    int64_t* ino_kind = a.leaf[LEAF_k_ino_kind] + lane * MAX_INODES;
    int64_t* ino_name = a.leaf[LEAF_k_ino_name] + lane * MAX_INODES;
    int64_t* ino_size = a.leaf[LEAF_k_ino_size] + lane * MAX_INODES;
    int64_t* rngp = a.leaf[LEAF_k_rng] + lane;
    int64_t* mem = a.leaf[LEAF_mem] + lane * MEM_WORDS;
    const int64_t ipl = MAX_INODES * FILE_WORDS;

    // -- fd resolution (indices clipped before every gather) ----------------
    const int64_t fd = x0;
    const bool fd_inr = fd >= 0 && fd < MAX_FDS;
    const int64_t fdc = clampi(fd, 0, MAX_FDS - 1);
    const int64_t ofd = fd_ofd[fdc];
    const bool fd_valid = fd_inr && ofd >= 0;
    const int64_t ofdc = clampi(ofd, 0, MAX_FDS - 1);
    const int64_t okind = ofd_kind[ofdc], oino = ofd_ino[ofdc];
    const int64_t ooff = ofd_off[ofdc], oflags = ofd_flags[ofdc];
    const int64_t oref = ofd_ref[ofdc];
    const int64_t inoc = clampi(oino, 0, MAX_INODES - 1);
    const int64_t isize = ino_size[inoc];

    // -- free-slot scans: lowest (and second lowest) free slot, 0 when there
    // is none (jnp.argmax of an all-false row) -------------------------------
    int n_free_fd = 0, n_free_ofd = 0;
    int64_t fd_a = -1, fd_b = -1, ofd_a = -1, ofd_b = -1, ino_a = -1;
    for (int i = 0; i < MAX_FDS; ++i) {
        if (fd_ofd[i] < 0) {
            ++n_free_fd;
            if (fd_a < 0) fd_a = i;
            else if (fd_b < 0) fd_b = i;
        }
        if (ofd_kind[i] == FD_FREE) {
            ++n_free_ofd;
            if (ofd_a < 0) ofd_a = i;
            else if (ofd_b < 0) ofd_b = i;
        }
    }
    for (int i = 0; i < MAX_INODES; ++i)
        if (ino_kind[i] == INO_FREE && ino_a < 0) ino_a = i;
    const bool has_ino = ino_a >= 0;
    if (fd_a < 0) fd_a = 0;
    if (fd_b < 0) fd_b = 0;
    if (ofd_a < 0) ofd_a = 0;
    if (ofd_b < 0) ofd_b = 0;
    if (ino_a < 0) ino_a = 0;

    SvcOut o;
    o.ret = 0;
    o.is_ret = fam != EF_NONE;
    o.rd_stream = sys_read && (!en || (fd_valid && okind == FD_RSTREAM));
    o.wr_stream = sys_write && (!en || (fd_valid && okind == FD_WSINK));

    // data-mover routing
    bool fio = false, dst_is_mem = false, src_proc = false, src_rand = false;
    int64_t nw = 0, mem_base = 0, ino_base = 0, proc_base = 0;
    const int64_t rng0 = *rngp;

    switch (fam) {
    case EF_OPEN: {
        const bool pvalid = mem_ok(x1);
        const int64_t name = path_w;
        const bool is_proc = name == PROC_KEY, is_dev = name == DEV_KEY;
        const bool is_file = !is_proc && !is_dev;
        bool exists = false;
        int64_t ino_hit = 0;
        for (int i = MAX_INODES - 1; i >= 0; --i)
            if (ino_kind[i] == INO_FILE && ino_name[i] == name) {
                exists = true;
                ino_hit = i;
            }
        const bool o_creat = (x2 & O_CREAT) != 0, o_excl = (x2 & O_EXCL) != 0;
        const bool o_trunc = (x2 & O_TRUNC) != 0;
        const bool need_create = is_file && !exists;
        int64_t err = 0;
        if (!pvalid) err = -EMUL_EFAULT;
        else if (is_file && !exists && !o_creat) err = -EMUL_ENOENT;
        else if (is_file && exists && o_creat && o_excl) err = -EMUL_EEXIST;
        else if (n_free_fd < 1) err = -EMUL_EMFILE;
        else if (n_free_ofd < 1) err = -EMUL_ENFILE;
        else if (need_create && !has_ino) err = -EMUL_ENOSPC;
        o.ret = err == 0 ? fd_a : err;
        if (err == 0) {
            fd_ofd[fd_a] = ofd_a;
            ofd_kind[ofd_a] = is_proc ? FD_PROC : (is_dev ? FD_DEV : FD_FILE);
            ofd_ino[ofd_a] = need_create ? ino_a : ino_hit;
            ofd_off[ofd_a] = 0;
            ofd_flags[ofd_a] = x2;
            ofd_ref[ofd_a] = 1;
            if (need_create) {
                ino_kind[ino_a] = INO_FILE;
                ino_name[ino_a] = name;
                ino_size[ino_a] = 0;
            } else if (is_file && o_trunc) {  // exists
                ino_size[ino_hit] = 0;
            }
        }
        break;
    }
    case EF_CLOSE:
        o.ret = fd_valid ? 0 : -EMUL_EBADF;
        if (fd_valid) {
            fd_ofd[fdc] = -1;
            if (oref <= 1) {
                ofd_kind[ofdc] = FD_FREE;
                ofd_ino[ofdc] = 0;
                ofd_off[ofdc] = 0;
                ofd_flags[ofdc] = 0;
            }
            ofd_ref[ofdc] = wsub(oref, 1) < 0 ? 0 : wsub(oref, 1);
        }
        break;
    case EF_DUP:
        o.ret = !fd_valid ? -EMUL_EBADF : (n_free_fd < 1 ? -EMUL_EMFILE : fd_a);
        if (fd_valid && n_free_fd >= 1) {
            fd_ofd[fd_a] = ofd;
            ofd_ref[ofdc] = wadd(oref, 1);
        }
        break;
    case EF_LSEEK: {
        const bool whence_ok = x2 >= SEEK_SET && x2 <= SEEK_END;
        const int64_t seek_new = x2 == SEEK_SET ? x1
                               : (x2 == SEEK_CUR ? wadd(ooff, x1) : wadd(isize, x1));
        int64_t err = 0;
        if (!fd_valid) err = -EMUL_EBADF;
        else if (okind != FD_FILE) err = -EMUL_ESPIPE;
        else if (!whence_ok) err = -EMUL_EINVAL;
        else if (seek_new < 0) err = -EMUL_EINVAL;
        o.ret = err == 0 ? seek_new : err;
        if (err == 0) ofd_off[ofdc] = seek_new;
        break;
    }
    case EF_FSTAT: {
        const bool sbuf_ok = mem_ok(x1) && wadd(x1, STAT_WORDS * 8) <= MEM_LIMIT;
        const int64_t err = !fd_valid ? -EMUL_EBADF : (!sbuf_ok ? -EMUL_EFAULT : 0);
        o.ret = err;
        if (err == 0) {
            const int64_t size = okind == FD_PROC ? PROC_WORDS * 8
                : ((okind == FD_PIPE_R || okind == FD_PIPE_W || okind == FD_FILE)
                   ? isize : 0);
            int64_t* sb = mem + widx(x1);
            sb[0] = okind;
            sb[1] = oino;
            sb[2] = size;
            sb[3] = 1;
        }
        break;
    }
    case EF_PIPE: {
        const bool pbuf_ok = mem_ok(x0) && wadd(x0, 16) <= MEM_LIMIT;
        int64_t err = 0;
        if (x1 != 0) err = -EMUL_EINVAL;
        else if (!pbuf_ok) err = -EMUL_EFAULT;
        else if (n_free_fd < 2) err = -EMUL_EMFILE;
        else if (n_free_ofd < 2) err = -EMUL_ENFILE;
        else if (!has_ino) err = -EMUL_ENOSPC;
        o.ret = err;
        if (err == 0) {
            fd_ofd[fd_a] = ofd_a;
            fd_ofd[fd_b] = ofd_b;
            ofd_kind[ofd_a] = FD_PIPE_R;
            ofd_kind[ofd_b] = FD_PIPE_W;
            ofd_ino[ofd_a] = ino_a;
            ofd_ino[ofd_b] = ino_a;
            ofd_off[ofd_a] = 0;
            ofd_off[ofd_b] = 0;
            ofd_flags[ofd_a] = 0;
            ofd_flags[ofd_b] = 0;
            ofd_ref[ofd_a] = 1;
            ofd_ref[ofd_b] = 1;
            ino_kind[ino_a] = INO_PIPE;
            ino_name[ino_a] = 0;
            ino_size[ino_a] = 0;
            int64_t* pb = mem + widx(x0);
            pb[0] = fd_a;
            pb[1] = fd_b;
        }
        break;
    }
    case EF_RAND: {
        const int64_t rand_n = clampi(x1, 0, FILE_BYTES);
        int64_t err = 0;
        if (x1 < 0 || (x1 & 7) != 0) err = -EMUL_EINVAL;
        else if (!(mem_ok(x0) && wadd(x0, rand_n) <= MEM_LIMIT)) err = -EMUL_EFAULT;
        o.ret = err == 0 ? rand_n : err;
        if (err == 0) {
            *rngp = wadd(rng0, rand_n >> 3);
            nw = rand_n >> 3;
            fio = nw > 0;
            dst_is_mem = src_rand = true;
            mem_base = lane * MEM_WORDS + widx(x0);
        }
        break;
    }
    case EF_IOCTL: {
        const int64_t val = x1 == ASC_IOCTL_ICOUNT ? v.icount
                          : x1 == ASC_IOCTL_HOOKS ? v.hook_count
                          : x1 == ASC_IOCTL_PID ? v.pid : -EMUL_EINVAL;
        o.ret = !fd_valid ? -EMUL_EBADF : (okind != FD_DEV ? -EMUL_ENOTTY : val);
        break;
    }
    default:
        break;
    }

    if (sys_read && en) {  // file / proc / pipe / device reads
        const bool rd_data = fd_valid && (okind == FD_FILE || okind == FD_PROC
                                          || okind == FD_PIPE_R);
        const bool rd_dev = fd_valid && okind == FD_DEV;
        if (!o.rd_stream) {  // rd_data, rd_dev or a bad fd / wrong direction
            o.is_ret = true;
            const int64_t src_size = okind == FD_PROC ? PROC_WORDS * 8 : isize;
            const int64_t err = !io_ok ? -EMUL_EFAULT : ((ooff & 7) != 0 ? -EMUL_EINVAL : 0);
            int64_t rd_n = wsub(src_size, ooff);
            rd_n = io_n < rd_n ? io_n : rd_n;
            rd_n = rd_n < 0 ? 0 : rd_n;
            o.ret = rd_data ? (err == 0 ? rd_n : err) : (rd_dev ? 0 : -EMUL_EBADF);
            if (rd_data && err == 0) {
                ofd_off[ofdc] = wadd(ooff, rd_n);
                nw = rd_n >> 3;
                fio = nw > 0;
                dst_is_mem = true;
                src_proc = okind == FD_PROC;
                mem_base = lane * MEM_WORDS + widx(x1);
                const int64_t ow = ooff >> 3;
                ino_base = lane * ipl + inoc * FILE_WORDS + clampi(ow, 0, FILE_WORDS - 1);
                proc_base = lane * PROC_WORDS + clampi(ow, 0, PROC_WORDS - 1);
            }
        }
    }
    if (sys_write && en) {  // file / pipe / device writes
        const bool wr_data = fd_valid && (okind == FD_FILE || okind == FD_PIPE_W);
        const bool wr_dev = fd_valid && okind == FD_DEV;
        if (!o.wr_stream) {
            o.is_ret = true;
            const bool w_is_pipe = okind == FD_PIPE_W;
            const int64_t w_off = (w_is_pipe || (oflags & O_APPEND) != 0) ? isize : ooff;
            const int64_t w_end = wadd(w_off, io_n);
            int64_t err = 0;
            if (!io_ok) err = -EMUL_EFAULT;
            else if ((w_off & 7) != 0) err = -EMUL_EINVAL;
            else if (w_end > FILE_BYTES) err = w_is_pipe ? -EMUL_EAGAIN : -EMUL_EFBIG;
            o.ret = wr_data ? (err == 0 ? io_n : err)
                  : (wr_dev ? (io_ok ? io_n : -EMUL_EFAULT) : -EMUL_EBADF);
            if (wr_data && err == 0) {
                if (!w_is_pipe) ofd_off[ofdc] = w_end;
                ino_size[inoc] = w_is_pipe ? w_end : (isize > w_end ? isize : w_end);
                nw = io_n >> 3;
                fio = nw > 0;
                mem_base = lane * MEM_WORDS + widx(x1);
                ino_base = lane * ipl + inoc * FILE_WORDS
                         + clampi(w_off >> 3, 0, FILE_WORDS - 1);
            }
        }
    }
    o.served = o.is_ret || (en && (o.rd_stream || o.wr_stream));

    // -- the data mover (run_data_loop): whole-plane index arithmetic --------
    if (fio) {
        int64_t* mem_plane = a.leaf[LEAF_mem];
        int64_t* ino_plane = a.leaf[LEAF_k_ino_data];
        const int64_t mtot = a.n_lanes * MEM_WORDS;
        const int64_t itot = a.n_lanes * ipl;
        const int64_t ptot = a.n_lanes * PROC_WORDS;
        if (dst_is_mem) {
            const uint64_t stream = splitmix64((uint64_t)rng0 * 0x10001ull + 1ull);
            for (int64_t j = 0; j < nw; ++j) {
                int64_t val;
                if (src_rand) {
                    val = (int64_t)splitmix64(stream + (uint64_t)j);
                } else if (src_proc) {
                    // the lane's own /proc row, from the pre-step counters
                    const int64_t w = clampi(proc_base + j, 0, ptot - 1) - lane * PROC_WORDS;
                    switch (w) {
                        case 0: val = v.virt_getpid != 0 ? VIRT_PID : v.pid; break;
                        case 1: val = v.icount; break;
                        case 2: val = v.cycles; break;
                        case 3: val = v.hook_count; break;
                        case 4: val = v.enosys_count; break;
                        case 5: val = v.emul_served; break;
                        case 6: val = v.in_off; break;
                        case 7: val = v.out_count; break;
                        case 8: val = v.out_sum; break;
                        case 9: val = v.fuel; break;
                        default: val = 0; break;
                    }
                } else {
                    val = ino_plane[clampi(ino_base + j, 0, itot - 1)];
                }
                const int64_t d = mem_base + j;
                if (d < mtot) mem_plane[d] = val;
            }
        } else {
            for (int64_t j = 0; j < nw; ++j) {
                const int64_t d = ino_base + j;
                if (d < itot) ino_plane[d] = mem_plane[clampi(mem_base + j, 0, mtot - 1)];
            }
        }
    }
    return o;
}

// The policy gate (K2) for one lane's svc: the action for `nr` from the
// lane's policy row (a later row wins, as in the JAX select chain).
struct Verdict {
    int64_t pol_arg, slot;
    bool exec, deny, emul, kill, emul_const;
};

__device__ __noinline__ Verdict policy_gate(const MegastepArgs& a,
                                            const int64_t lane,
                                            const int64_t nr, const bool en,
                                            const int64_t* sys_nr,
                                            const int64_t* sys_emul) {
    const int32_t* action_row =
        (const int32_t*)a.tleaf[TLEAF_pol_action] + lane * N_POLICY_SLOTS;
    const int64_t* arg_row = a.tleaf[TLEAF_pol_arg] + lane * N_POLICY_SLOTS;
    int64_t action = action_row[SLOT_UNKNOWN];
    Verdict v;
    v.pol_arg = arg_row[SLOT_UNKNOWN];
    v.slot = SLOT_UNKNOWN;
    bool emulable = false;
    for (int i = 0; i < N_SYSCALLS; ++i) {
        if (nr != sys_nr[i]) continue;
        action = action_row[i];
        v.pol_arg = arg_row[i];
        v.slot = i;
        if (sys_emul[i]) emulable = true;
    }
    v.deny = action == POL_DENY;
    v.emul = action == POL_EMULATE;
    v.kill = action == POL_KILL;
    // EMULATE on a guest-kernel-backed nr routes into the emulation service
    const bool emul_route = v.emul && emulable && en;
    v.emul_const = v.emul && !(emulable && en);
    v.exec = action == POL_ALLOW || emul_route;
    return v;
}

// One record into the lane's ring at row hot*cap + (count - base) % cap
// (JAX's flooring %, and mode="drop" indexing: a negative row counts from
// the end), one histogram bump, the verdict counters.
__device__ __noinline__ void trace_append(const MegastepArgs& a,
                                          const int64_t lane,
                                          const int64_t* rec,
                                          const Verdict v) {
    const int64_t cap = a.trace_cap;
    const int64_t count = a.tleaf[TLEAF_count][lane];
    const int64_t nrows = a.n_lanes * 2 * cap;
    int64_t pos = wadd(wadd(lane * 2 * cap, wmul(a.tleaf[TLEAF_hot][lane], cap)),
                       floor_mod(wsub(count, a.tleaf[TLEAF_base][lane]), cap));
    if (pos < 0) pos = wadd(pos, nrows);
    if (pos >= 0 && pos < nrows) {
        int64_t* row = a.tleaf[TLEAF_buf] + pos * REC_WORDS;
        for (int i = 0; i < REC_WORDS; ++i) row[i] = rec[i];
    }
    int64_t* h = a.tleaf[TLEAF_hist]
        + (lane * N_POLICY_SLOTS + v.slot) * N_VERDICTS + rec[REC_WORDS - 1];
    *h = wadd(*h, 1);
    a.tleaf[TLEAF_count][lane] = wadd(count, 1);
    int64_t* verdicts = a.tleaf[v.deny ? TLEAF_deny_count
                                : v.emul ? TLEAF_emul_count : TLEAF_kill_count];
    if (v.deny || v.emul || v.kill) verdicts[lane] = wadd(verdicts[lane], 1);
}

__global__ void megastep_kernel(const MegastepArgs a) {
    __shared__ int32_t s_alu[N_OPS], s_flags[N_OPS], s_memc[N_OPS], s_pcc[N_OPS];
    __shared__ uint8_t s_wb_sp[N_OPS], s_wb_lr[N_OPS], s_addr_post[N_OPS],
        s_wb_base[N_OPS], s_segv[N_OPS], s_exit[N_OPS];
    __shared__ int64_t s_signo[N_OPS], s_cost[N_OPS], s_cond[16];
    __shared__ int64_t s_sys_nr[N_SYSCALLS], s_sys_kind[N_SYSCALLS],
        s_sys_const[N_SYSCALLS], s_sys_emul[N_SYSCALLS];
    for (int i = threadIdx.x; i < N_OPS; i += blockDim.x) {
        s_alu[i] = a.alu[i];
        s_flags[i] = a.flags[i];
        s_memc[i] = a.memc[i];
        s_pcc[i] = a.pcc[i];
        s_wb_sp[i] = a.wb_sp[i];
        s_wb_lr[i] = a.wb_lr[i];
        s_addr_post[i] = a.addr_post[i];
        s_wb_base[i] = a.wb_base[i];
        s_segv[i] = a.segv[i];
        s_exit[i] = a.exit_[i];
        s_signo[i] = a.signo[i];
        s_cost[i] = a.cost[i];
    }
    for (int i = threadIdx.x; i < 16; i += blockDim.x) s_cond[i] = a.cond_mask[i];
    for (int i = threadIdx.x; i < N_SYSCALLS; i += blockDim.x) {
        s_sys_nr[i] = a.sys_nr[i];
        s_sys_kind[i] = a.sys_kind[i];
        s_sys_const[i] = a.sys_const[i];
        s_sys_emul[i] = a.sys_emul[i];
    }
    __syncthreads();

    const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= a.n_lanes) return;  // the ragged edge of the last block

    // -- load the lane's carry ---------------------------------------------
    int64_t r[31];
    int64_t* regs_p = a.leaf[LEAF_regs] + lane * 31;
    for (int i = 0; i < 31; ++i) r[i] = regs_p[i];
    int64_t sp = a.leaf[LEAF_sp][lane];
    int64_t pc = a.leaf[LEAF_pc][lane];
    int64_t nzcv = a.leaf[LEAF_nzcv][lane];
    int64_t cycles = a.leaf[LEAF_cycles][lane];
    int64_t icount = a.leaf[LEAF_icount][lane];
    const int64_t fuel = a.leaf[LEAF_fuel][lane];
    int64_t halted = a.leaf[LEAF_halted][lane];
    int64_t exit_code = a.leaf[LEAF_exit_code][lane];
    int64_t fault_pc = a.leaf[LEAF_fault_pc][lane];
    const int64_t sig_handler = a.leaf[LEAF_sig_handler][lane];
    int64_t in_signal = a.leaf[LEAF_in_signal][lane];
    const bool in_pt = a.leaf[LEAF_ptrace][lane] != 0;
    const int64_t virt_getpid = a.leaf[LEAF_virt_getpid][lane];
    const bool virt = in_pt && virt_getpid != 0;
    int64_t hook_count = a.leaf[LEAF_hook_count][lane];
    const int64_t pid = a.leaf[LEAF_pid][lane];
    int64_t in_off = a.leaf[LEAF_in_off][lane];
    int64_t out_count = a.leaf[LEAF_out_count][lane];
    int64_t out_sum = a.leaf[LEAF_out_sum][lane];
    int64_t enosys_count = a.leaf[LEAF_enosys_count][lane];
    int64_t emul_served = a.leaf[LEAF_emul_served][lane];
    const bool en = a.leaf[LEAF_k_enabled][lane] != 0;
    int64_t* mem = a.leaf[LEAF_mem] + lane * MEM_WORDS;
    const int64_t img_row = a.ids[lane];
    const int64_t* code = a.packed + img_row * CODE_WORDS;
    const int64_t* imms = a.imm + img_row * CODE_WORDS;

    const bool traced = a.trace_cap > 0;  // K2

    for (int64_t t = 0; t < a.chunk; ++t) {
        // A lane that is not live stays not live for the rest of the chunk
        // (halted never returns to RUNNING, icount only grows while live),
        // and masked steps are the identity: stop early.
        if (!(halted == RUNNING && icount < fuel)) break;
        const int64_t pc0 = pc, sp0 = sp, nzcv0 = nzcv;

        // -- fetch + decode ------------------------------------------------
        const bool ok_fetch = pc0 >= 0 && pc0 < CODE_LIMIT && (pc0 & 3) == 0;
        const int64_t fi = clampi(pc0 >> 2, 0, CODE_WORDS - 1);
        const int64_t w = code[fi];
        const int64_t imm = imms[fi];
        int op = ok_fetch ? (int)(w & 63) : OP_NULLPAGE;
        if (op > N_OPS - 1) op = N_OPS - 1;  // JAX gathers clamp the index
        const int rd = (int)((w >> 6) & 31);
        const int rn = (int)((w >> 11) & 31);
        const int rm = (int)((w >> 16) & 31);
        const int sh = (int)((w >> 22) & 63);
        const int cond = (int)((w >> 28) & 15);
        const int sf = (int)((w >> 32) & 1);

        const int aluc = s_alu[op], flagc = s_flags[op];
        const int memc = s_memc[op], pcc = s_pcc[op];
        const bool m_svc = pcc == P_SVC;
        const bool m_null = s_segv[op] != 0;
        const bool m_hlt = s_exit[op] != 0;
        const bool dlv = pcc == P_TRAP;
        const bool ld_single = memc == M_LOAD, st_single = memc == M_STORE;
        const bool ld_pair = memc == M_LOAD_P, st_pair = memc == M_STORE_P;
        const bool st_byte = memc == M_STORE_BYTE;
        const bool byte_op = memc == M_LOAD_BYTE || st_byte;

        // -- register reads (reg 31 is XZR for _rr, SP for _rsp) -----------
        const int ra = (int)clampi(imm, 0, 31);  // madd packs ra into imm
        const int64_t rn_raw = r[rn < 30 ? rn : 30];
        const int64_t rn_rr = rn == 31 ? 0 : rn_raw;
        const int64_t rn_rsp = rn == 31 ? sp0 : rn_raw;
        const int64_t rm_rr = rm == 31 ? 0 : r[rm < 30 ? rm : 30];
        const int64_t rd_rr = rd == 31 ? 0 : r[rd < 30 ? rd : 30];
        const int64_t ra_rr = ra == 31 ? 0 : r[ra < 30 ? ra : 30];
        const int64_t x0 = r[0], x1 = r[1], x2 = r[2], nr = r[8];
        const int64_t io_buf = x1, io_n = x2;

        // -- memory addressing ---------------------------------------------
        const int64_t addr_a = s_addr_post[op] ? rn_rsp : wadd(rn_rsp, imm);
        const int64_t eff1 = byte_op ? (addr_a & ~(int64_t)7) : addr_a;
        const bool ok1 = byte_op ? (addr_a >= DATA_BASE && addr_a < MEM_LIMIT)
                                 : mem_ok(eff1);
        const int64_t addr2 = wadd(addr_a, 8);
        const bool ok2 = mem_ok(addr2);
        const int64_t g1 = widx(eff1), g2 = widx(addr2);
        // Reads come from the pre-store memory.  The words are consumed only
        // by memory-class ops, so other ops skip the loads.
        int64_t v1 = 0, v2 = 0;
        if (memc != M_NONE || aluc == A_LOAD || aluc == A_LOAD_B) v1 = mem[g1];
        if (ld_pair) v2 = mem[g2];

        const int64_t byte_shift = (addr_a & 7) * 8;
        const int64_t byte_val = (v1 >> byte_shift) & 0xFF;
        const int64_t strb_word =
            (int64_t)(((uint64_t)v1 & ~((uint64_t)0xFF << byte_shift))
                      | (((uint64_t)rd_rr & 0xFF) << byte_shift));
        const int64_t ld1 = ok1 ? v1 : 0;
        const int64_t ld2 = ok2 ? v2 : 0;

        // -- ALU / mov / load value for the primary register write ----------
        // (the class switch is the JAX select chain: the classes are
        // disjoint, one per op)
        const int64_t piece = wshl(imm, sh);
        int64_t slot_val = 0;
        switch (aluc) {
            case A_MOVZ:
            case A_MOVN:
            case A_MOVK: {
                int64_t mv;
                if (aluc == A_MOVZ) mv = piece;
                else if (aluc == A_MOVN) mv = ~piece;
                else mv = (int64_t)(((uint64_t)rd_rr & ~((uint64_t)0xFFFF << sh))
                                    | (uint64_t)piece);
                if (sf != 1) mv &= (int64_t)0xFFFFFFFF;
                slot_val = mv;
                break;
            }
            case A_ADRP: slot_val = wadd(pc0 & ~(int64_t)0xFFF, imm); break;
            case A_ADR: slot_val = wadd(pc0, imm); break;
            case A_ADD_I: slot_val = wadd(rn_rsp, imm); break;
            case A_SUB_I: slot_val = wsub(rn_rsp, imm); break;
            case A_ADD_R: slot_val = wadd(rn_rr, rm_rr); break;
            case A_SUB_R: slot_val = wsub(rn_rr, rm_rr); break;
            case A_ORR: slot_val = rn_rr | rm_rr; break;
            case A_AND: slot_val = rn_rr & rm_rr; break;
            case A_EOR: slot_val = rn_rr ^ rm_rr; break;
            case A_MADD: slot_val = wadd(wmul(rn_rr, rm_rr), ra_rr); break;
            case A_LSL: slot_val = wshl(rn_rr, sh); break;
            case A_LOAD: slot_val = ld1; break;
            case A_LOAD_B: slot_val = byte_val; break;
            case A_LINK: slot_val = wadd(pc0, 4); break;
            default: break;
        }

        // -- flags (NZCV from a subtract) -----------------------------------
        if (flagc != F_NONE) {
            const bool f_imm = flagc == F_SUBS_I;
            const int64_t fa = f_imm ? rn_rsp : rn_rr;
            const int64_t fb = f_imm ? imm : rm_rr;
            const int64_t res = wsub(fa, fb);
            nzcv = (res < 0 ? 8 : 0) + (res == 0 ? 4 : 0)
                 + ((uint64_t)fa >= (uint64_t)fb ? 2 : 0)  // carry: unsigned
                 + (((fa ^ fb) & (fa ^ res)) < 0 ? 1 : 0);
        }

        // -- the policy gate (K2): only ALLOW lanes and EMULATE lanes routed
        // into the guest kernel reach the syscall branches -----------------
        Verdict pv;
        pv.pol_arg = 0;
        pv.slot = SLOT_UNKNOWN;
        pv.exec = m_svc;
        pv.deny = pv.emul = pv.kill = pv.emul_const = false;
        if (traced && m_svc) pv = policy_gate(a, lane, nr, en, s_sys_nr, s_sys_emul);
        const bool svc_exec = pv.exec;

        // -- syscalls: the spec's rows, split on the emulation gate ------------
        // Emulation off: openat / close return their historical constants
        // and the other emulated kinds fall through to -ENOSYS.
        bool sys_read = false, sys_write = false, sys_getpid = false;
        bool sys_exit = false, sys_sigret = false, sys_const = false;
        bool known = false;
        int fam = EF_NONE;
        int64_t const_val = 0;
        if (svc_exec) {
            for (int i = 0; i < N_SYSCALLS; ++i) {
                if (nr != s_sys_nr[i]) continue;
                const int64_t kind = s_sys_kind[i];
                bool k = true;
                if (kind == K_IO_READ) sys_read = true;
                else if (kind == K_IO_WRITE) sys_write = true;
                else if (kind == K_GETPID) sys_getpid = true;
                else if (kind == K_EXIT) sys_exit = true;
                else if (kind == K_SIGRETURN) sys_sigret = true;
                else if (kind == K_OPENAT || kind == K_CLOSE) {
                    if (en) {
                        fam = kind == K_OPENAT ? EF_OPEN : EF_CLOSE;
                    } else {
                        sys_const = true;
                        const_val = s_sys_const[i];
                    }
                } else if (kind == K_CONST) {
                    sys_const = true;
                    const_val = s_sys_const[i];
                } else if (en) {  // the emulation-only kinds
                    fam = kind == K_LSEEK ? EF_LSEEK : kind == K_DUP ? EF_DUP
                        : kind == K_FSTAT ? EF_FSTAT : kind == K_PIPE2 ? EF_PIPE
                        : kind == K_GETRANDOM ? EF_RAND : EF_IOCTL;
                } else {
                    k = false;
                }
                known = known || k;
            }
        }
        const bool sys_enosys = svc_exec && !known;
        const bool sys_io = sys_read || sys_write;

        const int64_t io_k = clampi(io_n >> 3, 0, MAX_IO_WORDS);
        const bool io_ok = mem_ok(io_buf) && wadd(io_buf, io_n) <= MEM_LIMIT
                           && io_n >= 0 && (io_n & 7) == 0;
        const int64_t io_start = widx(io_buf);
        // the openat path word, from the pre-store memory
        const int64_t path_w = fam == EF_OPEN ? mem[widx(x1)] : 0;

        // -- guest-kernel service (K3) ---------------------------------------
        SvcOut eo;
        eo.ret = 0;
        eo.is_ret = eo.served = false;
        eo.rd_stream = sys_read;
        eo.wr_stream = sys_write;
        if (fam != EF_NONE || (sys_io && en)) {
            const LaneView view = {icount, cycles, hook_count, enosys_count,
                                   emul_served, in_off, out_count, out_sum,
                                   fuel, pid, virt_getpid};
            eo = emul_service(a, lane, fam, sys_read, sys_write, en, x0, x1, x2,
                              path_w, io_ok, io_n, view);
        }
        const bool io_stream = eo.rd_stream || eo.wr_stream;

        int64_t svc_x0 = 0;
        if (io_stream) svc_x0 = io_ok ? io_n : -EMUL_EFAULT;
        else if (eo.is_ret) svc_x0 = eo.ret;
        else if (sys_getpid) svc_x0 = virt ? VIRT_PID : pid;
        else if (sys_const) svc_x0 = const_val;
        else if (sys_enosys) svc_x0 = -EMUL_ENOSYS;
        bool svc_x0_en = svc_exec && !(sys_exit || sys_sigret);
        if (pv.deny) svc_x0 = wsub(0, pv.pol_arg);
        else if (pv.emul_const) svc_x0 = pv.pol_arg;
        svc_x0_en = svc_x0_en || pv.deny || pv.emul_const;

        // -- signal delivery -------------------------------------------------
        const bool can_sig = dlv && sig_handler != 0 && in_signal == 0;
        const bool trap_fail = dlv && !can_sig;

        // -- memory writes, in the JAX order: stores, sigframe push, (the
        // service's result words,) stream I/O, (the data mover) ------------
        // JAX parks disabled stores at out-of-range indices and drops them;
        // here a disabled store is simply not made.  A pair store whose
        // second word faults keeps its first.
        if ((st_single || st_pair || st_byte) && ok1)
            mem[g1] = byte_op ? strb_word : rd_rr;
        if (st_pair && ok2) mem[g2] = rm_rr;
        if (can_sig) {  // the frame saves the PRE-step registers and flags
            int64_t* f = mem + SIGFRAME_IDX;
            for (int i = 0; i < 31; ++i) f[i] = r[i];
            f[31] = sp0;
            f[32] = pc0;
            f[33] = nzcv0;
        }
        // Stream I/O: words [io_start, io_start + io_k) of the lane — the
        // net effect of the JAX engine's clamped 512-word windows (io_ok
        // keeps the span inside the lane).  The write sum reads memory after
        // the stores.
        int64_t io_sum = 0;
        if (io_stream && io_ok) {
            int64_t* p = mem + io_start;
            if (sys_read) {
                for (int64_t j = 0; j < io_k; ++j) p[j] = wadd(in_off, j * 8);
            } else {
                for (int64_t j = 0; j < io_k; ++j) io_sum = wadd(io_sum, p[j]);
            }
        }

        // -- register writes (slot order of the JAX executor) ----------------
        if (aluc != A_NONE) {
            const int idx = s_wb_lr[op] ? 30 : rd;
            if (idx < 31) r[idx] = slot_val;
            else if (s_wb_sp[op]) sp = slot_val;  // _wsp ops: rd 31 is SP
        }
        if (ld_pair && rm < 31) r[rm] = ld2;
        if (s_wb_base[op]) {
            const int64_t v = wadd(rn_rsp, imm);
            if (rn < 31) r[rn] = v;
            else sp = v;
        }
        if (svc_x0_en) r[0] = svc_x0;
        if (can_sig) {
            r[0] = s_signo[op];
            r[1] = SIGFRAME;
            sp = SIGSTACK_TOP;
        }
        int64_t frame_pc = 0, frame_x0 = 0;
        if (sys_sigret) {  // the frame is read from the FINAL memory
            const int64_t* f = mem + SIGFRAME_IDX;
            for (int i = 0; i < 31; ++i) r[i] = f[i];
            sp = f[31];
            frame_pc = f[32];
            nzcv = f[33];
            frame_x0 = f[0];
        }

        // -- program counter (b.cond tests the OLD flags) --------------------
        const int64_t br = wadd(pc0, imm), pc4 = wadd(pc0, 4);
        switch (pcc) {
            case P_REL: pc = br; break;
            case P_IND: pc = rn_rr; break;
            case P_CBZ: pc = rd_rr == 0 ? br : pc4; break;
            case P_CBNZ: pc = rd_rr != 0 ? br : pc4; break;
            case P_BCOND: pc = ((s_cond[cond] >> (nzcv0 & 15)) & 1) ? br : pc4; break;
            case P_STAY: pc = pc0; break;
            case P_TRAP: pc = can_sig ? sig_handler : pc0; break;
            case P_SVC:  // KILL parks like exit
                pc = (sys_exit || pv.kill) ? pc0
                   : (sys_sigret ? wadd(frame_pc, 4) : pc4);
                break;
            default: pc = pc4; break;
        }

        // -- faults / halts (later assignments win, as in the JAX chain) ----
        const bool mem_bad = ((ld_single || st_single) && !ok1)
                             || ((ld_pair || st_pair) && !(ok1 && ok2))
                             || (byte_op && !ok1);
        if (m_null) halted = HALT_SEGV;
        if (mem_bad) halted = HALT_BADMEM;
        if (m_hlt || sys_exit) {
            halted = HALT_EXIT;
            exit_code = x0;
        }
        if (trap_fail) halted = HALT_TRAP;
        if (m_null || mem_bad || trap_fail) fault_pc = pc0;
        if (pv.kill) {
            halted = HALT_KILL;
            fault_pc = pc0;
        }

        // -- trace record, histogram, verdict counters (K2) ------------------
        if (traced && m_svc) {
            const int64_t rec[REC_WORDS] = {
                icount, pc0, nr, x0, x1, x2,
                pv.deny ? wsub(0, pv.pol_arg) : pv.emul_const ? pv.pol_arg
                    : pv.kill ? 0 : sys_exit ? x0 : sys_sigret ? frame_x0 : svc_x0,
                pv.deny ? POL_DENY : pv.emul ? POL_EMULATE : pv.kill ? POL_KILL
                    : sys_enosys ? VERDICT_UNKNOWN : POL_ALLOW};
            trace_append(a, lane, rec, pv);
        }

        // -- bookkeeping -----------------------------------------------------
        cycles = wadd(cycles, s_cost[op]);
        if (m_svc) {
            cycles = wadd(cycles, KERNEL_CROSS);
            if (in_pt) {
                cycles = wadd(cycles, 2 * PTRACE_STOP);
                hook_count = wadd(hook_count, 1);
            }
        }
        if (sys_io) cycles = wadd(cycles, floor_div(io_n, IO_BYTES_PER_CYCLE));
        if (can_sig) cycles = wadd(cycles, SIGNAL_DELIVERY);
        icount = wadd(icount, 1);
        if (eo.rd_stream && io_ok) in_off = wadd(in_off, io_n);
        if (eo.wr_stream && io_ok) {
            out_count = wadd(out_count, io_n);
            out_sum = wadd(out_sum, io_sum);
        }
        if (can_sig) in_signal = 1;
        else if (sys_sigret) in_signal = 0;
        if (sys_enosys) enosys_count = wadd(enosys_count, 1);
        if (eo.served) emul_served = wadd(emul_served, 1);
    }

    // -- merged writeback -----------------------------------------------------
    for (int i = 0; i < 31; ++i) regs_p[i] = r[i];
    a.leaf[LEAF_sp][lane] = sp;
    a.leaf[LEAF_pc][lane] = pc;
    a.leaf[LEAF_nzcv][lane] = nzcv;
    a.leaf[LEAF_cycles][lane] = cycles;
    a.leaf[LEAF_icount][lane] = icount;
    a.leaf[LEAF_halted][lane] = halted;
    a.leaf[LEAF_exit_code][lane] = exit_code;
    a.leaf[LEAF_fault_pc][lane] = fault_pc;
    a.leaf[LEAF_in_signal][lane] = in_signal;
    a.leaf[LEAF_hook_count][lane] = hook_count;
    a.leaf[LEAF_in_off][lane] = in_off;
    a.leaf[LEAF_out_count][lane] = out_count;
    a.leaf[LEAF_out_sum][lane] = out_sum;
    a.leaf[LEAF_enosys_count][lane] = enosys_count;
    a.leaf[LEAF_emul_served][lane] = emul_served;
}

// Launch on `stream` (PyTorch's current stream); no synchronisation.
// Returns cudaGetLastError() so the wrapper can raise on a refused launch.
extern "C" int megastep_launch(const MegastepArgs* args, int block, void* stream) {
    const int64_t grid = (args->n_lanes + block - 1) / block;
    megastep_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}
